"""The port's hybrid family (RG-LRU and local attention, recurrentgemma-9b)
against the JAX reference, on the CPU.

Reduced ``recurrentgemma-9b``: 2 groups of (rglru, rglru, attn) and one
RG-LRU tail block (7 layers), d 64, rnn width 64, hq 4 / hkv 1, dh 16,
local window 8.  The reference builds the params (``init_params``,
``rglru_init``; once a run through ``test_torch_refcache``) and
``repro_torch.convert`` carries them across; inputs are made with numpy
from a seed.  Tolerances, each of max |reference|:

* the RG-LRU scan and block in f32: the state ``h`` within 1e-6 (the same
  f32 arithmetic, the products' sums in XLA's order against torch's);
  the causal-conv state, a slice of the ``w_x`` projection, within the
  same limit, and bit for bit where both sides get the same projection;
* whole reduced models: the LM tolerances of ``tests/test_torch_lm.py``
  (fp32 1e-5, kom_int14 2e-3, native_bf16 3e-2 of max |logit|), with
  prompts longer than the window, so that prefill's window masks keys and
  decode's ring wraps.  With ``use_flash_kernel=True`` the reference runs
  its Pallas kernel in interpret mode, the port the kernel's plain
  version.

The reference's ``test_interleaved_admission_matches_single_slot_decode``
fails for this model under its default ``native_bf16``: the bf16 results
of a step depend on what a request is batched with.  Under ``fp32`` the
write mask and the admission reset isolate the state, and the port's twin
holds batched == solo token for token there (ROADMAP.md, Queue 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.precision import MatmulPolicy as RefPolicy  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as ref_flash_attention)
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core.precision import MatmulPolicy  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from test_torch_refcache import (cached, digest, init_numpy,  # noqa: E402
                                 refcache_session)  # noqa: F401

ARCH = "recurrentgemma-9b"
#: the RG-LRU state in f32, of max |reference|
TOL_H = 1e-6
#: policy -> (compute dtype, tolerance on max|diff| / max|logit|)
POLICIES = {"fp32": ("float32", 1e-5), "kom_int14": ("float32", 2e-3),
            "native_bf16": ("bfloat16", 3e-2)}


def _cfgs(policy="fp32", **kw):
    cd = POLICIES[policy][0]
    ref = ref_reduced(ref_get_config(ARCH)).replace(
        policy=RefPolicy(policy), compute_dtype=cd, **kw)
    port = reduced(get_config(ARCH)).replace(
        policy=MatmulPolicy(policy), compute_dtype=cd, **kw)
    return ref, port


def _params(seed=1):
    """The reference's params (drawn once a run; they depend on neither the
    policy nor the compute dtype) and the port's copy."""
    ref_cfg = ref_reduced(ref_get_config(ARCH))
    tree = init_numpy("lm-init", (repr(ref_cfg), seed), lambda:
                      ref_T.init_params(ref_cfg, jax.random.PRNGKey(seed)))
    return (jax.tree.map(jnp.asarray, tree),
            lm_params_from_numpy(tree, device="cpu"))


def _carry(tree):
    return lm_params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(1, 256, shape).astype(
        np.int32)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


# -- params and cache -----------------------------------------------------------

def test_param_trees_and_cache_match_reference():
    """``init_params`` makes the reference's tree (names, shapes, dtypes,
    also under a bf16 ``param_dtype``; ``lam`` stays f32), ``convert``
    carries the reference's tree across leaf for leaf, and ``init_cache``
    the reference's cache (the ring ``min(window, max_len)`` slots long)."""
    rp, tp = _params()
    ref_leaves = _flat(jax.tree.map(np.asarray, rp))
    assert set(_flat(tp)) == set(ref_leaves)
    for name, t in _flat(tp).items():
        np.testing.assert_array_equal(t.numpy(), ref_leaves[name])
    for pdt in ("float32", "bfloat16"):
        ref_cfg, cfg = (c.replace(param_dtype=pdt) for c in _cfgs())
        want = _flat(jax.eval_shape(lambda: ref_T.init_params(
            ref_cfg, jax.random.PRNGKey(0))))
        got = _flat(T.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"))
        assert set(got) == set(want)
        for name, t in got.items():
            assert tuple(t.shape) == want[name].shape, name
            assert str(t.dtype) == f"torch.{want[name].dtype}", name
    assert {"groups/b0/mixer/lam", "groups/b2/mixer/wq", "tail/mlp/w_gate",
            "tail/mixer/conv_w"} <= set(ref_leaves)
    ref_cfg, cfg = _cfgs()
    for max_len in (5, 16):
        want = ref_T.init_cache(ref_cfg, 3, max_len)
        got = T.init_cache(cfg, 3, max_len, device="cpu")
        pairs = [(got["tail"], want["tail"])] + [
            (got["groups"][n], want["groups"][n]) for n in want["groups"]]
        for ours, theirs in pairs:
            assert type(ours).__name__ == type(theirs).__name__
            for g, w in zip(ours, theirs):
                assert tuple(g.shape) == w.shape
                assert str(g.dtype) == f"torch.{w.dtype}"
                assert not g.any()
        assert got["groups"]["b2"].k.shape[3] == min(8, max_len)


# -- the RG-LRU -------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 7, 16, 37])
def test_rglru_scan_matches_reference(s):
    """The associative scan in the reference's odd/even order, at lengths
    that are and are not powers of two, and against the plain recurrence
    in f64."""
    r = np.random.default_rng(s)
    xg = r.standard_normal((2, s, 5)).astype(np.float32)
    log_a = np.log(r.uniform(0.5, 0.99, (2, s, 5))).astype(np.float32)
    want = np.asarray(jax.jit(ref_ssm._rglru_scan)(jnp.array(xg),
                                                   jnp.array(log_a)))
    got = ssm._rglru_scan(torch.from_numpy(xg), torch.from_numpy(log_a))
    assert _rel(got, want) <= TOL_H
    a = np.exp(log_a.astype(np.float64))
    bt = np.sqrt(1 - a * a) * xg
    h, seq = np.zeros((2, 5)), []
    for t in range(s):
        h = a[:, t] * h + bt[:, t]
        seq.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(seq, 1), rtol=1e-5,
                               atol=1e-6)


def _block_inputs(cfg, s, seed):
    return (np.random.default_rng(seed).standard_normal(
        (2, s, cfg.d_model)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("s", [16, 13])
def test_rglru_block_matches_jitted_reference(s):
    """Prefill (s = 16 and 13, not a power of two), then two decode steps
    from the prefill's state: y within the f32 LM tolerance, ``h`` within
    TOL_H, the conv state within it too; given the reference's own
    ``w_x`` projection the conv state is the same bits."""
    rc, pc = _cfgs()
    rp = ref_ssm.rglru_init(jax.random.PRNGKey(s), rc)
    tp = _carry(rp)
    x = _block_inputs(pc, s + 2, 20 + s)
    blk = jax.jit(lambda p, xx, st: ref_ssm.rglru_block(p, xx, rc, st))
    want, wst = jax.jit(lambda p, xx: ref_ssm.rglru_block(p, xx, rc))(
        rp, jnp.array(x[:, :s]))
    with torch.inference_mode():
        got, gst = ssm.rglru_block(tp, torch.from_numpy(x[:, :s]), pc)
    assert _rel(got, want) <= POLICIES["fp32"][1]
    assert _rel(gst.h, wst.h) <= TOL_H and _rel(gst.conv, wst.conv) <= TOL_H
    for t in range(s, s + 2):
        want, wst = blk(rp, jnp.array(x[:, t:t + 1]), wst)
        with torch.inference_mode():
            got, gst = ssm.rglru_block(tp, torch.from_numpy(x[:, t:t + 1]),
                                       pc, state=gst)
        assert _rel(got, want) <= POLICIES["fp32"][1]
        assert _rel(gst.h, wst.h) <= TOL_H
        assert _rel(gst.conv, wst.conv) <= TOL_H
    xb = np.asarray(jnp.array(x) @ rp["w_x"])
    _, want_conv = ref_ssm.causal_conv1d(jnp.array(xb), rp["conv_w"])
    from repro_torch.models.layers import causal_conv1d
    _, got_conv = causal_conv1d(torch.from_numpy(xb.copy()), tp["conv_w"])
    np.testing.assert_array_equal(got_conv.numpy(), np.asarray(want_conv))


def test_rglru_decode_matches_forward():
    """Step-by-step decode from a zero state reproduces the prefill scan
    (``tests/test_recurrence.py``'s tolerance)."""
    rc, pc = _cfgs()
    tp = _carry(ref_ssm.rglru_init(jax.random.PRNGKey(0), rc))
    x = torch.from_numpy(_block_inputs(pc, 9, 11))
    with torch.inference_mode():
        full, _ = ssm.rglru_block(tp, x, pc)
        st = ssm.RGLRUState(torch.zeros((2, pc.rnn_width)),
                            torch.zeros((2, 3, pc.rnn_width)))
        ys = []
        for t in range(9):
            yt, st = ssm.rglru_block(tp, x[:, t:t + 1], pc, state=st)
            ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1), full, rtol=1e-4, atol=1e-5)


# -- the flash kernel's plain version at dh 256 -----------------------------------

def test_flash_plain_dh256_matches_reference_kernel():
    """recurrentgemma's head dim: b 1, hq 2, hkv 1, 256 x 256, window 64,
    f32; the port's plain version within 2e-5 of max |ref| of the
    reference's Pallas kernel in interpret mode."""
    r = np.random.default_rng(256)
    q = r.standard_normal((1, 2, 256, 256)).astype(np.float32)
    k, v = (r.standard_normal((1, 1, 256, 256)).astype(np.float32)
            for _ in range(2))
    want = cached("hybrid-flash-256", digest(q, k, v), lambda: np.asarray(
        ref_flash_attention(*(jnp.array(a) for a in (q, k, v)),
                            causal=True, window=64)))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True, window=64)
    assert _rel(got, want) <= 2e-5


# -- whole models -------------------------------------------------------------------

def _ref_run(policy, fn):
    """``fn`` jitted, or op by op under native_bf16: compiled, XLA:CPU keeps
    excess precision through the model's bf16 casts, and the recurrence
    carries that drift to 1.4-3.5% of max |logit| over ten decode steps;
    op by op (every bf16 cast rounded, as torch rounds it) the reference
    and the port agree (``tests/test_torch_ssm.py`` does the same)."""
    if policy != "native_bf16":
        return jax.jit(fn)

    def eager(*a):
        with jax.disable_jit():
            return fn(*a)
    return eager


def _ref_forward(ref_cfg, rp, toks):
    """``jax.jit`` of the reference's forward, once a run."""
    return cached("hybrid-forward", (repr(ref_cfg), digest(toks)),
                  lambda: np.asarray(jax.jit(
                      lambda p, t: ref_T.forward(p, ref_cfg,
                                                 {"tokens": t})[0])(
                          rp, jnp.array(toks))))


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_forward_matches_jitted_reference(policy, flash):
    """12 tokens through a window of 8, each policy, the flash kernel off
    and on."""
    ref_cfg, cfg = _cfgs(policy, use_flash_kernel=flash)
    rp, tp = _params()
    toks = _tokens((2, 12), 3)
    want = _ref_forward(ref_cfg, rp, toks)
    got, aux = T.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert got.shape == (2, 12, cfg.padded_vocab)
    assert _rel(got, want) <= POLICIES[policy][1], _rel(got, want)


def test_ring_local_attention_matches_reference_across_the_wrap():
    """One attention block's ring decode, positions 0..19 through 8 slots
    (the ring wraps twice): output and both ring tensors within the f32
    limit of the jitted reference's at every step; the step writes slot
    ``pos mod 8`` and no other."""
    ref_cfg, cfg = _cfgs()
    rp, tp = _params()
    lp_ref = jax.tree.map(lambda a: a[0], rp["groups"]["b2"]["mixer"])
    lp = T.layer_params(tp["groups"]["b2"], 0)["mixer"]
    ring = jax.jit(lambda p, x, c, pos: ref_T._ring_local_attention(
        p, x, ref_cfg, c, pos, 8))
    x = _block_inputs(cfg, 20, 30)
    shape = (2, cfg.n_kv_heads, 8, cfg.head_dim)
    rc = ref_attention.KVCache(jnp.zeros(shape), jnp.zeros(shape))
    c = KVCache(torch.zeros(shape), torch.zeros(shape))
    for pos in range(20):
        want, rc = ring(lp_ref, jnp.array(x[:, pos:pos + 1]), rc,
                        jnp.int32(pos))
        with torch.inference_mode():
            got, new = T._ring_local_attention(
                lp, torch.from_numpy(x[:, pos:pos + 1]), cfg, c, pos, 8)
        assert _rel(got, want) <= POLICIES["fp32"][1], pos
        for g, w in zip(new, rc):
            assert _rel(g, w) <= POLICIES["fp32"][1], pos
        others = [i for i in range(8) if i != pos % 8]
        for g, old in zip(new, c):
            assert torch.equal(g[:, :, others], old[:, :, others])
        c = new


@pytest.mark.parametrize("policy", list(POLICIES))
def test_serve_step_matches_jitted_reference(policy):
    """Ten decode steps on a 2-row cache of 16 (the ring holds 8: it
    wraps), the second row writing every other step: logits and every
    state leaf within the policy's tolerance of the reference's (jitted;
    op by op under native_bf16, see :func:`_ref_run`)."""
    ref_cfg, cfg = _cfgs(policy)
    rp, tp = _params()
    b = 2
    rcache = ref_T.init_cache(ref_cfg, b, 16)
    cache = T.init_cache(cfg, b, 16, device="cpu")
    step = _ref_run(policy, lambda p, c, t, pos, m: ref_T.serve_step(
        p, ref_cfg, c, t, pos, write_mask=m))
    toks = _tokens((b, 10), 5)
    tol = POLICIES[policy][1]
    for t in range(10):
        m = np.array([True, t % 2 == 0])
        rl, rcache = step(rp, rcache, jnp.array(toks[:, t:t + 1]),
                          jnp.int32(t), jnp.array(m))
        tl, cache = T.serve_step(tp, cfg, cache,
                                 torch.from_numpy(toks[:, t:t + 1]), t,
                                 write_mask=torch.from_numpy(m))
        assert tl.shape == (b, 1, cfg.padded_vocab)
        assert _rel(tl, rl) <= tol, (t, _rel(tl, rl))
    pairs = [(cache["tail"], rcache["tail"])] + [
        (cache["groups"][n], rcache["groups"][n]) for n in rcache["groups"]]
    for ours, theirs in pairs:
        for g, w in zip(ours, theirs):
            assert _rel(g.float(), w) <= tol


@pytest.mark.parametrize("policy", ["fp32", "kom_int14"])
def test_decode_matches_forward(policy):
    """The ring decode reproduces the teacher-forced forward over 12
    positions with a window of 8 (``tests/test_decode_consistency.py``'s
    tolerance)."""
    _, cfg = _cfgs(policy)
    _, tp = _params()
    b, s = 2, 12
    toks = torch.from_numpy(_tokens((b, s), 6))
    tf, _ = T.forward(tp, cfg, {"tokens": toks})
    cache = T.init_cache(cfg, b, s + 2, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = T.serve_step(tp, cfg, cache, toks[:, t:t + 1], t)
        outs.append(lg.reshape(b, -1))
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(dec[:, 1:].numpy(), tf[:, 1:].numpy(),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(dec[:, -1].argmax(-1), tf[:, -1].argmax(-1))
    with pytest.raises(ValueError, match="one token a step"):
        T.serve_step(tp, cfg, cache, toks[:, :2], s)


def test_write_mask_keeps_masked_rows_bit_for_bit():
    """Every ring K/V, ``h`` and conv leaf of a masked-out row stays bit for
    bit across a wrap; the raw step changes them."""
    _, cfg = _cfgs()
    _, tp = _params()
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    fresh = T.init_cache(cfg, 2, 16, device="cpu")

    def leaves(c):
        return [leaf for st in [c["tail"], *c["groups"].values()]
                for leaf in st]
    for t in range(10):
        _, cache = T.serve_step(tp, cfg, cache, torch.tensor([[5 + t], [7]]),
                                t, write_mask=torch.tensor([True, False]))
    assert len(leaves(cache)) == 8
    for got, zero in zip(leaves(cache), leaves(fresh)):
        assert not torch.equal(got[:, 0], zero[:, 0])
        assert torch.equal(got[:, 1], zero[:, 1])
    _, raw = T.serve_step(tp, cfg, cache, torch.tensor([[3], [9]]), 10)
    for got, kept in zip(leaves(raw), leaves(cache)):
        assert not torch.equal(got[:, 1], kept[:, 1])


def test_reset_rows_restores_the_ring_and_rglru_state():
    """The engine's admission reset puts a slot's ring, ``h`` and conv
    leaves back to zero and leaves the other slot's alone."""
    _, cfg = _cfgs()
    _, tp = _params()
    eng = ServeEngine(cfg, tp, slots=2, max_len=16, device="cpu")
    eng.submit(Request(uid=0, prompt=_tokens((6,), 1), max_new_tokens=4))
    eng.submit(Request(uid=1, prompt=_tokens((5,), 2), max_new_tokens=4))
    eng.run()
    eng._reset_rows(eng._mask([0]))
    c, c0 = eng.cache, eng._cache0
    for st, st0 in [(c["tail"], c0["tail"])] + [
            (c["groups"][n], c0["groups"][n]) for n in c["groups"]]:
        for leaf, leaf0 in zip(st, st0):
            assert torch.equal(leaf[:, 0], leaf0[:, 0])
            assert not torch.equal(leaf[:, 1], leaf0[:, 1])


def test_interleaved_admission_matches_single_slot_decode_fp32():
    """The twin of the reference's
    ``tests/test_serve_cache_isolation.py::
    test_interleaved_admission_matches_single_slot_decode`` for this
    model, with its prompts (the second draw of ``default_rng(7)``) and
    params (``PRNGKey(3)``), under ``fp32``: staggered admission into a
    2-slot engine gives each request the tokens it gets alone."""
    rng = np.random.default_rng(7)
    for _ in range(2):  # the reference draws granite's prompts first
        prompts = [rng.integers(1, 256, (n,)).astype(np.int32)
                   for n in (7, 3, 4)]
    _, cfg = _cfgs()
    _, tp = _params(seed=3)
    eng = ServeEngine(cfg, tp, slots=2, max_len=64, device="cpu")
    eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=6))
    for _ in range(3):
        eng.step()
    for uid, p in enumerate(prompts[1:], start=1):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
    done = eng.run()
    assert sorted(done) == [0, 1, 2]
    for uid, prompt in enumerate(prompts):
        solo = ServeEngine(cfg, tp, slots=1, max_len=64, device="cpu")
        solo.submit(Request(uid=0, prompt=prompt, max_new_tokens=6))
        assert done[uid].out_tokens == solo.run()[0].out_tokens, uid


def test_launcher_serves_recurrentgemma_on_cpu(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", ARCH, "--reduced", "--device", "cpu",
                 "--requests", "3", "--slots", "2", "--max-new", "3",
                 "--policy", "kom_int14"]) == 0
    out = capsys.readouterr().out
    assert f"{ARCH}/kom_int14 on cpu: 3 requests" in out
