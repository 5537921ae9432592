"""The port's xLSTM family and chunkwise-mLSTM op against the JAX reference,
on the CPU.

The reference builds the params (``init_params``, ``mlstm_init``,
``slstm_init``) and ``repro_torch.convert.lm_params_from_numpy`` carries
them across; inputs are made with numpy from a seed.  Tolerances, each of
max |reference|:

* the op and the blocks in f32: :data:`TOL_OP` (2e-5).  Both sides run the
  same f32 arithmetic with sums in another order (XLA's dots and cumsum
  against torch's); the two land ~1e-7..1e-6 apart, and the mutants (the
  causal mask without the diagonal, the state written without the input
  gate) land orders of magnitude further;
* whole reduced models: the LM tolerances of ``tests/test_torch_lm.py``
  (fp32 1e-5, kom_int14 2e-3, native_bf16 3e-2 of max |logit|), for the
  same reasons (an ulp in an activation can move a 14-bit level; bf16
  rounds at other places).  Under ``native_bf16`` the reference runs op
  by op (``jax.disable_jit()``), not jitted: compiled, XLA:CPU keeps
  excess precision through the model's bf16 casts (its default
  ``--xla_allow_excess_precision``), and the recurrences carry that
  1-2 ulp drift to 2.6-4.2% of max |logit| at s 24-128, where the op-by-op
  reference (every bf16 cast rounded, as torch rounds it) lies 0.3-1.1%
  from the port (ROADMAP.md, Queue 3).
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.precision import MatmulPolicy as RefPolicy  # noqa: E402
from repro.core.substrate import QWeight as RefQWeight  # noqa: E402
from repro.kernels.mlstm_chunk import mlstm_chunk as ref_mlstm_chunk  # noqa: E402
from repro.kernels.mlstm_chunk import mlstm_ref as ref_mlstm_ref  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.serving import weight_quant as ref_wq  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.analysis.roofline import mlstm_chunk_roofline  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core.precision import MatmulPolicy  # noqa: E402
from repro_torch.core.substrate import QWeight  # noqa: E402
from repro_torch.kernels.mlstm_chunk import (mlstm_chunk,  # noqa: E402
                                             mlstm_chunk_plain,
                                             mlstm_chunk_raw, mlstm_ref)
from repro_torch.models import layers, ssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serving.weight_quant import quantize_params_inline  # noqa: E402
from test_torch_refcache import (init_numpy,  # noqa: E402
                                 refcache_session)  # noqa: F401

TOL_OP = 2e-5
#: policy -> (compute dtype, tolerance of max |logit|), as test_torch_lm.py
POLICIES = {"fp32": ("float32", 1e-5), "kom_int14": ("float32", 2e-3),
            "native_bf16": ("bfloat16", 3e-2)}
ARCH = "xlstm-125m"


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _op_inputs(b, h, s, dh, seed=0):
    """tests/test_mlstm_kernel.py's distributions, from a seed."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, h, s, dh)).astype(np.float32)
    k = (r.standard_normal((b, h, s, dh)) * 0.3).astype(np.float32)
    v = r.standard_normal((b, h, s, dh)).astype(np.float32)
    lf = np.log(r.uniform(0.7, 0.99, (b, h, s))).astype(np.float32)
    ig = r.uniform(0.1, 0.9, (b, h, s)).astype(np.float32)
    return q, k, v, lf, ig


def _both(arrays):
    return ([jnp.array(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@contextlib.contextmanager
def _mutant(name):
    """The plain version with one piece of its arithmetic changed."""
    if name == "strict_causal":       # `>` for `>=`: each token's own key
        attr, fn = "causal_mask", lambda c, dev: torch.tril(
            torch.ones((c, c), dtype=torch.bool, device=dev), diagonal=-1)
    else:                             # the state written without i_gate
        attr, fn = "state_write_weights", \
            lambda ltot, lcum, ig: ssm._clip_exp(ltot - lcum)
    orig = getattr(ssm, attr)
    setattr(ssm, attr, fn)
    try:
        yield
    finally:
        setattr(ssm, attr, orig)


# -- the op against the reference's Pallas kernel (interpret mode) ------------

@pytest.mark.parametrize("b,h,s,dh,c", [
    (2, 2, 64, 16, 16),
    (1, 4, 128, 32, 64),
    (1, 2, 100, 16, 32),   # padded (s % chunk != 0)
    (2, 1, 32, 64, 32),
])
def test_op_matches_reference_kernel(b, h, s, dh, c):
    (rq, tq) = _both(_op_inputs(b, h, s, dh))
    want = np.asarray(ref_mlstm_chunk(*rq, chunk=c))
    got = mlstm_chunk(*tq, chunk=c)
    assert got.dtype == torch.float32 and got.shape == (b, h, s, dh)
    assert _rel(got, want) <= TOL_OP, _rel(got, want)


def test_op_chunk_invariance():
    """Each chunk against the reference at the same chunk (TOL_OP), and the
    chunks against each other at the reference test's own tolerance."""
    (rq, tq) = _both(_op_inputs(1, 2, 64, 16, seed=1))
    outs = []
    for c in (8, 16, 32, 64):
        got = mlstm_chunk(*tq, chunk=c).numpy()
        assert _rel(got, ref_mlstm_chunk(*rq, chunk=c)) <= TOL_OP
        outs.append(got)
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-4, atol=5e-4)


def test_op_bf16_inputs():
    """bf16 q/k/v are cast to f32 exactly on both sides: TOL_OP holds."""
    arrays = _op_inputs(1, 2, 64, 32, seed=2)
    rq = [jnp.array(a).astype(jnp.bfloat16) for a in arrays[:3]] + \
        [jnp.array(a) for a in arrays[3:]]
    tq = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:3]] + \
        [torch.from_numpy(a) for a in arrays[3:]]
    want = ref_mlstm_chunk(*rq, chunk=32)
    got = mlstm_chunk(*tq, chunk=32)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= TOL_OP


def test_op_short_sequence_and_zero_input_gates():
    """s < chunk runs one chunk of s; rows with i_gate = 0 write nothing."""
    q, k, v, lf, ig = _op_inputs(1, 2, 17, 16, seed=3)
    ig[:, :, ::3] = 0.0
    (rq, tq) = _both((q, k, v, lf, ig))
    assert _rel(mlstm_chunk(*tq, chunk=64), ref_mlstm_chunk(*rq, chunk=64)) \
        <= TOL_OP


def test_ref_matches_reference_ref():
    (rq, tq) = _both(_op_inputs(1, 2, 40, 16, seed=4))
    assert _rel(mlstm_ref(*tq), ref_mlstm_ref(*rq)) <= TOL_OP


@pytest.mark.parametrize("mutant", ["strict_causal", "no_input_gate"])
def test_mutants_miss_the_tolerance(mutant):
    (rq, tq) = _both(_op_inputs(1, 2, 64, 16, seed=5))
    want = ref_mlstm_chunk(*rq, chunk=16)
    assert _rel(mlstm_chunk(*tq, chunk=16), want) <= TOL_OP
    with _mutant(mutant):
        bad = mlstm_chunk(*tq, chunk=16)
    assert _rel(bad, want) > 100 * TOL_OP


def test_raw_wrapper_checks_shapes():
    q, k, v, lf, ig = (torch.from_numpy(a)
                       for a in _op_inputs(1, 1, 48, 16, seed=6))
    with pytest.raises(ValueError, match="multiple of chunk"):
        mlstm_chunk_raw(q, k, v, lf, ig, chunk=32)
    with pytest.raises(ValueError, match="gates"):
        mlstm_chunk_raw(q, k, v, lf[:, :, :40], ig, chunk=16)
    torch.testing.assert_close(mlstm_chunk_raw(q, k, v, lf, ig, chunk=16),
                               mlstm_chunk_plain(q, k, v, lf, ig, chunk=16),
                               rtol=0, atol=0)


def test_roofline_counts():
    """Per (b, h, chunk) at C 64, dh 384: the causal scores and y_intra
    2*2080*384 each, y_inter and the state update 2*64*384^2 each, the
    normalizer 2*2*64*384; the two CUDA kernels issue the full score tile
    and q . n in each of their 6 dv tiles, and the state walk, y_inter and
    the normalizers on 31 of the 32 chunks (chunk 0 starts from zero)."""
    rf = mlstm_chunk_roofline(b=4, h=4, s=2048, dh=384, chunk=64)
    per = 2 * 2 * 2080 * 384 + 2 * 2 * 64 * 384 ** 2 + 2 * 2 * 64 * 384
    assert rf["flops"] == 16 * 32 * per
    issued = (32 * (6 * 2 * 64 * 64 * 384 + 2 * 64 * 64 * 384)
              + 31 * (2 * 2 * 64 * 384 ** 2 + 6 * 2 * 64 * 384
                      + 2 * 64 * 384))
    assert rf["flops_issued"] == 16 * issued
    assert rf["scratch_bytes"] == 16 * 31 * (384 ** 2 + 384) * 4
    assert rf["bytes"] == 4 * 4 * 2048 * (3 * 384 * 4 + 8 + 4 * 384)
    assert rf["roofline_s"] == rf["compute_s"] > rf["memory_s"]
    assert rf["tf32x3_s"] == 3 * rf["flops"] / 494.7e12


# -- the blocks against jax.jit of the reference --------------------------------

def _block_cfgs(policy="fp32"):
    cd = POLICIES[policy][0]
    ref = ref_reduced(ref_get_config(ARCH)).replace(
        policy=RefPolicy(policy), compute_dtype=cd)
    port = reduced(get_config(ARCH)).replace(
        policy=MatmulPolicy(policy), compute_dtype=cd)
    return ref, port


def _carry(tree):
    return lm_params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def test_causal_conv1d_matches_reference():
    r = np.random.default_rng(7)
    x = r.standard_normal((2, 9, 12)).astype(np.float32)
    w = r.standard_normal((4, 12)).astype(np.float32)
    st = r.standard_normal((2, 3, 12)).astype(np.float32)
    for state in (None, st):
        want_y, want_s = ref_layers.causal_conv1d(
            jnp.array(x), jnp.array(w),
            None if state is None else jnp.array(state))
        got_y, got_s = layers.causal_conv1d(
            torch.from_numpy(x), torch.from_numpy(w),
            None if state is None else torch.from_numpy(state))
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("s", [64, 24])
def test_mlstm_block_matches_jitted_reference(s):
    """s = 64: one 64-chunk; s = 24: the fallback chunk of s (no padding).
    Output and every state leaf within TOL_OP."""
    rc, pc = _block_cfgs()
    rp = ref_ssm.mlstm_init(jax.random.PRNGKey(0), rc)
    tp = _carry(rp)
    x = (np.random.default_rng(8).standard_normal((2, s, rc.d_model))
         * 0.3).astype(np.float32)
    want, wst = jax.jit(lambda p, xx: ref_ssm.mlstm_block(p, xx, rc))(
        rp, jnp.array(x))
    with torch.inference_mode():
        got, gst = ssm.mlstm_block(tp, torch.from_numpy(x), pc)
    assert _rel(got, want) <= TOL_OP
    for g, w in zip(gst, wst):
        assert g.shape == w.shape and _rel(g, w) <= TOL_OP


@pytest.mark.parametrize("s", [64, 24])
def test_slstm_block_matches_jitted_reference(s):
    rc, pc = _block_cfgs()
    rp = ref_ssm.slstm_init(jax.random.PRNGKey(1), rc)
    tp = _carry(rp)
    x = (np.random.default_rng(9).standard_normal((2, s, rc.d_model))
         * 0.3).astype(np.float32)
    want, wst = jax.jit(lambda p, xx: ref_ssm.slstm_block(p, xx, rc))(
        rp, jnp.array(x))
    with torch.inference_mode():
        got, gst = ssm.slstm_block(tp, torch.from_numpy(x), pc)
    assert _rel(got, want) <= TOL_OP
    for g, w in zip(gst, wst):
        assert _rel(g, w) <= TOL_OP


def test_mlstm_chunk_invariance():
    """The chunk scan does not depend on the chunk (tests/test_recurrence.py's
    identity, at its tolerance)."""
    q, k, v, lf, ig = (torch.from_numpy(a)
                       for a in _op_inputs(2, 2, 32, 8, seed=10))
    s0, n0 = torch.zeros((2, 2, 8, 8)), torch.zeros((2, 2, 8))
    outs = [ssm._mlstm_chunk_scan(q, k, v, lf, ig, s0, n0, c)
            for c in (1, 4, 8, 32)]
    for y, st, nt in outs[1:]:
        np.testing.assert_allclose(y, outs[0][0], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(st, outs[0][1], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(nt, outs[0][2], rtol=2e-4, atol=2e-5)


def test_mlstm_decode_matches_forward():
    rc, pc = _block_cfgs()
    tp = _carry(ref_ssm.mlstm_init(jax.random.PRNGKey(0), rc))
    b, s = 1, 12
    x = torch.from_numpy((np.random.default_rng(11).standard_normal(
        (b, s, pc.d_model)) * 0.3).astype(np.float32))
    di, h = 2 * pc.d_model, pc.n_heads
    dh = di // h
    with torch.inference_mode():
        full, _ = ssm.mlstm_block(tp, x, pc, chunk=4)
        st = ssm.MLSTMState(torch.zeros((b, h, dh, dh)),
                            torch.zeros((b, h, dh)), torch.zeros((b, 3, di)))
        ys = []
        for t in range(s):
            yt, st = ssm.mlstm_block(tp, x[:, t:t + 1], pc, state=st)
            ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1), full, rtol=2e-3, atol=2e-3)


def test_slstm_decode_matches_forward():
    rc, pc = _block_cfgs()
    tp = _carry(ref_ssm.slstm_init(jax.random.PRNGKey(0), rc))
    b, s = 2, 10
    x = torch.from_numpy((np.random.default_rng(12).standard_normal(
        (b, s, pc.d_model)) * 0.3).astype(np.float32))
    with torch.inference_mode():
        full, _ = ssm.slstm_block(tp, x, pc)
        st = ssm.slstm_state0(b, pc.d_model, "cpu")
        ys = []
        for t in range(s):
            yt, st = ssm.slstm_block(tp, x[:, t:t + 1], pc, state=st)
            ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1), full, rtol=1e-4, atol=1e-5)


# -- the reduced model -----------------------------------------------------------

def _params(ref_cfg, seed=1):
    """The reference's params (drawn once per run, ``test_torch_refcache``)
    and the port's copy."""
    tree = init_numpy("lm-init", (repr(ref_cfg), seed), lambda:
                      ref_T.init_params(ref_cfg, jax.random.PRNGKey(seed)))
    return jax.tree.map(jnp.asarray, tree), _carry(tree)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, shape).astype(np.int32)


def _ref_run(policy, fn):
    """``fn`` jitted, or op by op under native_bf16 (module docstring)."""
    if policy != "native_bf16":
        return jax.jit(fn)

    def eager(*a):
        with jax.disable_jit():
            return fn(*a)
    return eager


def test_init_params_and_cache_match_reference_layout():
    rc, pc = _block_cfgs()
    rp = ref_T.init_params(rc, jax.random.PRNGKey(0))
    tp = T.init_params(pc, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree_util.tree_flatten_with_path(rp)[0]
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert len(got) == len(want)
    for path, leaf in want:
        g = got[jax.tree_util.keystr(path)]
        assert tuple(g.shape) == leaf.shape, path
    rcache = ref_T.init_cache(rc, 3, 8)
    cache = T.init_cache(pc, 3, 8, device="cpu")
    for name, st in rcache["groups"].items():
        ours = cache["groups"][name]
        assert type(ours).__name__ == type(st).__name__
        for g, w in zip(ours, st):
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w))


@pytest.mark.parametrize("s", [24, 64])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_forward_matches_jitted_reference(policy, s):
    rc, pc = _block_cfgs(policy)
    rp, tp = _params(rc)
    toks = _tokens(pc, (2, s), 3)
    want, _ = _ref_run(policy, lambda p, t: ref_T.forward(
        p, rc, {"tokens": t}))(rp, jnp.array(toks))
    got, aux = T.forward(tp, pc, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert got.shape == (2, s, pc.padded_vocab)
    assert _rel(got, want) <= POLICIES[policy][1], _rel(got, want)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_serve_step_matches_jitted_reference(policy):
    """Six decode steps on a shared 2-row cache, the second row writing
    every other step: logits and every state leaf within the policy's
    tolerance of the (jitted) reference."""
    rc, pc = _block_cfgs(policy)
    rp, tp = _params(rc)
    b = 2
    rcache = ref_T.init_cache(rc, b, 16)
    cache = T.init_cache(pc, b, 16, device="cpu")
    step = _ref_run(policy, lambda p, c, t, pos, m: ref_T.serve_step(
        p, rc, c, t, pos, write_mask=m))
    toks = _tokens(pc, (b, 6), 5)
    tol = POLICIES[policy][1]
    for t in range(6):
        m = np.array([True, t % 2 == 0])
        rl, rcache = step(rp, rcache, jnp.array(toks[:, t:t + 1]),
                          jnp.int32(t), jnp.array(m))
        tl, cache = T.serve_step(tp, pc, cache,
                                 torch.from_numpy(toks[:, t:t + 1]), t,
                                 write_mask=torch.from_numpy(m))
        assert _rel(tl, rl) <= tol, (t, _rel(tl, rl))
    for name, st in rcache["groups"].items():
        for g, w in zip(cache["groups"][name], st):
            assert _rel(g.float(), w) <= tol, name


def test_quantize_params_inline_bitwise():
    rc, _ = _block_cfgs("kom_int14")
    rp, tp = _params(rc)
    want = ref_wq.quantize_params_inline(rp)
    got = quantize_params_inline(tp)
    quantized = set()
    for i, kind in enumerate(rc.xlstm_group):
        wm, gm = want["groups"][f"b{i}"]["mixer"], \
            got["groups"][f"b{i}"]["mixer"]
        for name, w in wm.items():
            g = gm[name]
            if isinstance(w, RefQWeight):
                assert isinstance(g, QWeight)
                np.testing.assert_array_equal(g.values.numpy(),
                                              np.asarray(w.values))
                np.testing.assert_array_equal(g.scale.numpy(),
                                              np.asarray(w.scale))
                quantized.add(name)
            else:
                assert not isinstance(g, QWeight)
                for gl, wl in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
                    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert quantized == {"w_up", "w_gate", "wq", "wk", "wv", "w_in",
                         "w_down"}
    assert not isinstance(got["embed"], QWeight)


@pytest.mark.parametrize("policy", ["fp32", "kom_int14"])
def test_engine_greedy_tokens_match_reference_engine(policy):
    rc, pc = _block_cfgs(policy)
    rp, tp = _params(rc)
    prompts = [_tokens(pc, (n,), 10 + n) for n in (5, 3, 7)]
    eng = ServeEngine(pc, tp, slots=2, max_len=32, device="cpu")
    ref = RefEngine(rc, rp, slots=2, max_len=32)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=5))
        ref.submit(RefRequest(uid=uid, prompt=p, max_new_tokens=5))
    got, want = eng.run(), ref.run()
    assert sorted(got) == [0, 1, 2]
    assert {u: got[u].out_tokens for u in got} == \
        {u: want[u].out_tokens for u in want}


@pytest.mark.parametrize("policy", ["fp32", "kom_int14"])
def test_decode_matches_forward(policy):
    _, pc = _block_cfgs(policy)
    tp = T.init_params(pc, torch.Generator().manual_seed(1), device="cpu")
    b, s = 2, 10
    toks = torch.from_numpy(_tokens(pc, (b, s), 6))
    tf, _ = T.forward(tp, pc, {"tokens": toks})
    cache = T.init_cache(pc, b, s + 2, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = T.serve_step(tp, pc, cache, toks[:, t:t + 1], t)
        outs.append(lg.reshape(b, -1))
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(dec[:, 1:].numpy(), tf[:, 1:].numpy(),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(dec[:, -1].argmax(-1), tf[:, -1].argmax(-1))


@pytest.mark.parametrize("policy", ["fp32", "kom_int14"])
def test_interleaved_batched_decode_matches_single_slot(policy):
    """Staggered admission into a 2-slot engine (a slot reused by a later
    request) == each request served alone, token for token."""
    _, pc = _block_cfgs(policy)
    tp = T.init_params(pc, torch.Generator().manual_seed(3), device="cpu")
    prompts = [_tokens(pc, (n,), 20 + n) for n in (7, 3, 4)]
    eng = ServeEngine(pc, tp, slots=2, max_len=64, device="cpu")
    eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=6))
    for _ in range(3):
        eng.step()
    for uid, p in enumerate(prompts[1:], start=1):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
    done = eng.run()
    for uid, prompt in enumerate(prompts):
        solo = ServeEngine(pc, tp, slots=1, max_len=64, device="cpu")
        solo.submit(Request(uid=0, prompt=prompt, max_new_tokens=6))
        assert done[uid].out_tokens == solo.run()[0].out_tokens, uid


def test_write_mask_protects_other_rows_states():
    """Every mLSTM (s, n, conv) and sLSTM (h, c, n) leaf of a masked-out
    row stays bit for bit; the raw step changes them."""
    _, pc = _block_cfgs()
    tp = T.init_params(pc, torch.Generator().manual_seed(0), device="cpu")
    cache = T.init_cache(pc, 2, 8, device="cpu")
    for t in range(3):
        _, cache = T.serve_step(tp, pc, cache, torch.tensor([[5 + t], [7]]),
                                t, write_mask=torch.tensor([True, False]))
    fresh = T.init_cache(pc, 2, 8, device="cpu")
    leaves = [(n, i) for n in cache["groups"]
              for i in range(len(cache["groups"][n]))]
    assert len(leaves) == 12
    for n, i in leaves:
        row0 = cache["groups"][n][i][:, 0]
        assert not torch.equal(row0, fresh["groups"][n][i][:, 0]), (n, i)
        assert torch.equal(cache["groups"][n][i][:, 1],
                           fresh["groups"][n][i][:, 1]), (n, i)
    _, raw = T.serve_step(tp, pc, cache, torch.tensor([[3], [9]]), 3)
    for n, i in leaves:
        assert not torch.equal(raw["groups"][n][i][:, 1],
                               cache["groups"][n][i][:, 1]), (n, i)


def test_reset_rows_restores_slstm_normalizer_to_ones():
    _, pc = _block_cfgs()
    tp = T.init_params(pc, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(pc, tp, slots=2, max_len=16, device="cpu")
    eng.submit(Request(uid=0, prompt=_tokens(pc, (4,), 1), max_new_tokens=3))
    eng.submit(Request(uid=1, prompt=_tokens(pc, (5,), 2), max_new_tokens=3))
    eng.run()
    slstm = eng.cache["groups"]["b3"]
    assert not torch.equal(slstm.n[:, 0], torch.ones_like(slstm.n[:, 0]))
    eng._reset_rows(eng._mask([0]))
    groups = eng.cache["groups"]
    assert torch.equal(groups["b3"].n[:, 0],
                       torch.ones_like(groups["b3"].n[:, 0]))
    for name, st in groups.items():
        for leaf, leaf0 in zip(st, eng._cache0["groups"][name]):
            assert torch.equal(leaf[:, 0], leaf0[:, 0])
            assert not torch.equal(leaf[:, 1], leaf0[:, 1])


def test_launcher_serves_xlstm_on_cpu(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", ARCH, "--reduced", "--device", "cpu",
                 "--requests", "3", "--slots", "2", "--max-new", "3",
                 "--policy", "kom_int14"]) == 0
    out = capsys.readouterr().out
    assert f"{ARCH}/kom_int14 on cpu: 3 requests" in out


def test_float_weight_kom_ulp_noise_sets_its_card_limit():
    """kom_int14 on FLOAT weights quantizes both operands of every
    projection per tensor (``kom_q_dot``).  One f32 ulp on half of the
    embedding output moves the reduced xlstm's logits (forward and four
    decode steps) further than it moves them on weights quantized once,
    but within ``FLOAT_WEIGHTS_TOL``, the card-vs-CPU limit of that path;
    the ``base_bits=6`` control lands outside it (ROADMAP.md, Queue 3)."""
    from repro_torch.analysis.kom_float_weights import (FLOAT_WEIGHTS_TOL,
                                                        ulp_sensitivity)
    moves = ulp_sensitivity("cpu", seeds=range(4))
    assert max(moves["prequantized"]) < max(moves["float_weights"])
    assert max(moves["prequantized"]) <= 2e-3
    assert max(moves["float_weights"]) <= FLOAT_WEIGHTS_TOL
    assert min(moves["control_base_bits_6"]) > FLOAT_WEIGHTS_TOL
