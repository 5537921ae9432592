"""The port's MoE family (``repro_torch.models.moe`` and the MoE branch of
the transformer) against the JAX reference, on the CPU.

The reference builds the params (``moe_init``, ``init_params``) and
``repro_torch.convert.lm_params_from_numpy`` carries them across; inputs
are made with numpy from a seed.

Routing is discontinuous: an ulp in a layer's input can swap the k-th and
(k+1)-th expert and move that token's output by O(1).  So every
whole-model check first asserts that the port routed every (token, layer)
as the reference did -- the reference's routing is read out of its jitted
forward by ``jax.debug.callback``, the port's by wrapping
``moe.moe_route`` -- and only then compares values, so that a flip fails
as a flip and not as a tolerance miss.  Tolerances, each of max
|reference|:

* one ``moe_ffn``: :data:`TOL_FFN_F32` (1e-5) in f32 -- the expert
  products are f32 GEMMs summed in another order on each side (measured
  ~2e-7) -- and :data:`TOL_FFN_BF16` (2e-2, a few bf16 ulps) in bf16; the
  aux loss within :data:`TOL_AUX` (1e-6) relative: both sides average the
  same f32 probabilities;
* whole reduced models: ``tests/test_torch_lm.py``'s fp32 1e-5,
  kom_int14 2e-3 and native_bf16 3e-2 of max |logit|.
"""
import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.precision import MatmulPolicy as RefPolicy  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.serving import weight_quant as ref_wq  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core.precision import MatmulPolicy  # noqa: E402
from repro_torch.core.substrate import QWeight  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serving.weight_quant import quantize_params_inline  # noqa: E402
from test_torch_refcache import (init_numpy,  # noqa: E402
                                 refcache_session)  # noqa: F401

TOL_FFN_F32 = 1e-5
TOL_FFN_BF16 = 2e-2
TOL_AUX = 1e-6
#: policy -> (compute dtype, tolerance of max |logit|), as test_torch_lm.py
POLICIES = {"fp32": ("float32", 1e-5), "kom_int14": ("float32", 2e-3),
            "native_bf16": ("bfloat16", 3e-2)}
ARCHS = ["olmoe-1b-7b", "qwen3-moe-30b-a3b"]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cfgs(arch, policy, **kw):
    kw.setdefault("compute_dtype", POLICIES[policy][0])
    ref = ref_reduced(ref_get_config(arch)).replace(
        policy=RefPolicy(policy), **kw)
    port = reduced(get_config(arch)).replace(
        policy=MatmulPolicy(policy), **kw)
    return ref, port


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _lm_params():
    """The reference's params of reduced olmoe-1b-7b and the port's copy.
    Reduced qwen3-moe-30b-a3b differs from it only in ``rope_theta``, so
    both archs share them (``test_init_params_layout_matches_reference``
    checks the layouts); params are f32 whatever the policy."""
    ref_cfg, _ = _cfgs("olmoe-1b-7b", "fp32")
    tree = init_numpy("moe-init", (repr(ref_cfg), 1), lambda: jax.jit(
        lambda key: ref_T.init_params(ref_cfg, key))(jax.random.PRNGKey(1)))
    return (jax.tree.map(jnp.asarray, tree),
            lm_params_from_numpy(tree, device="cpu"))


@pytest.fixture(params=ARCHS)
def lm(request):
    """(arch, reference params, the port's copy)."""
    return (request.param,) + _lm_params()


# -- routing, as the reference computes it ------------------------------------

def _ref_route(params, xg, cfg):
    """The reference ``moe_ffn``'s own routing steps (``moe.py:50-62``) on
    groups ``xg`` (g, s, d): (probs, gate, idx, pos, keep)."""
    g, s, _ = xg.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    cap = ref_moe.moe_capacity(s, k, e, cfg.moe_capacity_factor)
    logits = jnp.einsum("gsd,de->gse", xg.astype(jnp.float32),
                        params["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate, idx = jax.lax.top_k(probs, k)
    gate = gate / jnp.sum(gate, axis=-1, keepdims=True)
    flat = jax.nn.one_hot(idx, e, dtype=jnp.float32).reshape(g, s * k, e)
    pos = jnp.sum(flat * (jnp.cumsum(flat, axis=1) - flat), axis=-1)
    return probs, gate, idx, pos.reshape(g, s, k), (pos < cap).reshape(
        g, s, k)


@contextlib.contextmanager
def _ref_routing():
    """Inside the block the reference transformer's ``moe_ffn`` reports
    every call's (idx, keep) to the host (``jax.debug.callback``, in
    call order: through ``jit`` and the layer scan); yields the list."""
    seen, orig = [], ref_T.moe_ffn

    def wrapped(params, x, cfg):
        b, s, d = x.shape
        gsz = min(cfg.moe_group_size, b * s)
        _, _, idx, _, keep = _ref_route(params, x.reshape(-1, gsz, d), cfg)
        jax.debug.callback(
            lambda i, kp: seen.append((np.asarray(i), np.asarray(kp))),
            idx, keep, ordered=True)
        return orig(params, x, cfg)
    ref_T.moe_ffn = wrapped
    try:
        yield seen
    finally:
        ref_T.moe_ffn = orig


@contextlib.contextmanager
def _port_routing():
    """Inside the block every ``moe.moe_route`` call's (idx, keep) is
    recorded, in call order; yields the list."""
    seen, orig = [], moe.moe_route

    def wrapped(params, xg, cfg):
        out = orig(params, xg, cfg)
        seen.append((out[2].numpy(), out[4].numpy()))
        return out
    moe.moe_route = wrapped
    try:
        yield seen
    finally:
        moe.moe_route = orig


def _same_routing(got, want):
    assert len(got) == len(want) and got, (len(got), len(want))
    for n, ((gi, gk), (wi, wk)) in enumerate(zip(got, want)):
        flips = int((gi != wi).any(-1).sum())
        assert flips == 0, f"call {n}: {flips} tokens routed differently"
        np.testing.assert_array_equal(gk, wk)


# -- (a) moe_route against the reference's steps ------------------------------

@functools.lru_cache(maxsize=None)
def _layer_params(seed=0):
    ref_cfg, _ = _cfgs("olmoe-1b-7b", "fp32")
    rp = ref_moe.moe_init(jax.random.PRNGKey(seed), ref_cfg)
    return rp, lm_params_from_numpy(jax.tree.map(np.asarray, rp),
                                    device="cpu")


def _layer(**kw):
    """Reduced olmoe's MoE layer from the reference (params, the port's
    copy, configs)."""
    return _layer_params() + _cfgs("olmoe-1b-7b", "fp32", **kw)


@pytest.mark.parametrize("cf", [4.0, 0.25])
def test_route_matches_reference_steps(cf):
    """Random inputs, roomy and tight capacity: idx, pos and keep equal,
    gates within 1e-6."""
    rp, tp, ref_cfg, cfg = _layer(moe_capacity_factor=cf)
    x = np.random.default_rng(2).standard_normal((3, 64, 64)).astype(
        np.float32)
    want = jax.jit(lambda p, v: _ref_route(p, v, ref_cfg))(rp, jnp.array(x))
    probs, gate, idx, pos, keep = moe.moe_route(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want[4]))
    assert np.abs(gate.numpy() - np.asarray(want[1])).max() <= 1e-6
    assert np.abs(probs.numpy() - np.asarray(want[0])).max() <= 1e-6
    assert (not keep.all()) == (cf < 1)


def test_route_ties_go_to_the_lower_index():
    """Zero rows (every probability equal) and a router with repeated
    columns (equal logits): idx equals ``lax.top_k``'s, the lower expert
    index first among equal probabilities."""
    rp, _, ref_cfg, cfg = _layer()
    router = np.array(rp["router"])
    router[:, 5], router[:, 6] = router[:, 2], router[:, 2]
    router[:, 7] = router[:, 0]
    rp = dict(rp, router=jnp.array(router))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    x = np.random.default_rng(4).standard_normal((1, 16, 64)).astype(
        np.float32)
    x[0, ::3] = 0.0
    want = jax.jit(lambda p, v: _ref_route(p, v, ref_cfg))(rp, jnp.array(x))
    _, _, idx, pos, keep = moe.moe_route(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want[3]))
    assert (idx.numpy()[0, ::3] == [0, 1]).all()
    _, top = jax.lax.top_k(jnp.array([[0.2, 0.1, 0.3, 0.3, 0.1]]), 3)
    p = torch.tensor([[0.2, 0.1, 0.3, 0.3, 0.1]])
    got = torch.sort(p, dim=-1, descending=True, stable=True)[1][:, :3]
    np.testing.assert_array_equal(got.numpy(), np.asarray(top))


# -- (b) moe_ffn against the jitted reference ---------------------------------

@functools.lru_cache(maxsize=None)
def _ffn_case(dtype, cf, seed=3):
    """(the port's params, config, input; the jitted reference's y and
    aux) of one MoE layer on a (2, 64) batch (one 128-token group)."""
    rp, tp, ref_cfg, cfg = _layer(moe_capacity_factor=cf,
                                  compute_dtype=dtype)
    x = np.random.default_rng(seed).standard_normal((2, 64, 64)).astype(
        np.float32)
    rx = jnp.array(x).astype(ref_cfg.dtype)
    want_y, want_aux = jax.jit(lambda p, v: ref_moe.moe_ffn(p, v, ref_cfg))(
        rp, rx)
    tx = torch.from_numpy(x).to(cfg.dtype)
    return tp, cfg, tx, np.asarray(want_y, np.float32), float(want_aux)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL_FFN_F32),
                                       ("bfloat16", TOL_FFN_BF16)])
@pytest.mark.parametrize("cf", [4.0, 0.25])
def test_moe_ffn_matches_jitted_reference(dtype, tol, cf):
    """y within the dtype's tolerance, aux within TOL_AUX; at capacity
    factor 0.25 the same tokens dropped, their rows exactly zero on both
    sides."""
    tp, cfg, x, want_y, want_aux = _ffn_case(dtype, cf)
    y, aux = moe.moe_ffn(tp, x, cfg)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert aux.dtype == torch.float32
    assert _rel(y.float(), want_y) <= tol, _rel(y.float(), want_y)
    assert abs(float(aux) - want_aux) <= TOL_AUX * want_aux
    zero = (y.float() == 0).all(-1).numpy()
    np.testing.assert_array_equal(zero, (want_y == 0).all(-1))
    assert zero.any() == (cf < 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [4.0, 0.5, 0.25])
def test_dispatch_and_combine_match_a_loop(cf, dtype):
    """``dispatch`` puts each kept (token, slot)'s token in row ``(group,
    pos)`` of its expert and leaves every other row zero; ``combine`` sums
    each token's kept slots times their gates (rounded to the compute
    dtype first) and adds nothing for a dropped slot: both against a loop
    over (group, token, slot), in float64 for the combine."""
    _, cfg = _prop_cfgs(e=8, k=2, gsz=16, cf=cf)
    tp = moe.moe_init(torch.Generator().manual_seed(3), cfg)
    dt = getattr(torch, dtype)
    xg = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)).to(dt)
    _, gate, idx, pos, keep = moe.moe_route(tp, xg, cfg)
    g, s, k = idx.shape
    e = cfg.moe_num_experts
    cap = moe.moe_capacity(s, k, e, cfg.moe_capacity_factor)
    assert (not keep.all()) == (cf < 1)
    buf = moe.dispatch(xg, idx, pos, keep, e, cap)
    want = torch.zeros_like(buf)
    for gi, t, j in np.ndindex(g, s, k):
        if keep[gi, t, j]:
            want[idx[gi, t, j], gi * cap + pos[gi, t, j]] = xg[gi, t]
    assert torch.equal(buf, want)
    out = torch.randn(buf.shape, generator=torch.Generator().manual_seed(
        4)).to(dt)
    y = moe.combine(out, gate, idx, pos, keep, cap)
    want_y = torch.zeros((g, s, cfg.d_model), dtype=torch.float64)
    for gi, t, j in np.ndindex(g, s, k):
        if keep[gi, t, j]:
            want_y[gi, t] += gate[gi, t, j].to(dt).double() * out[
                idx[gi, t, j], gi * cap + pos[gi, t, j]].double()
    tol = TOL_FFN_F32 if dtype == "float32" else TOL_FFN_BF16
    assert y.dtype == dt and _rel(y.float(), want_y.float()) <= tol
    np.testing.assert_array_equal((y == 0).all(-1).numpy(),
                                  (~keep).all(-1).numpy())


def _keep_last(params, xg, cfg):
    """Mutant: the LAST ``cap`` (token, slot) pairs of each expert kept."""
    probs, gate, idx, pos, keep = _ORIG_ROUTE(params, xg, cfg)
    g, s, k = idx.shape
    e = cfg.moe_num_experts
    flat = torch.nn.functional.one_hot(idx.reshape(g, s * k), e)
    after = flat.flip(1).cumsum(1).flip(1) - flat
    pos = torch.gather(after, 2, idx.reshape(g, s * k, 1)).reshape(g, s, k)
    cap = moe.moe_capacity(s, k, e, cfg.moe_capacity_factor)
    return probs, gate, idx, pos, pos < cap


def _raw_gates(params, xg, cfg):
    """Mutant: the top-k probabilities as gates, not renormalised."""
    probs, gate, idx, pos, keep = _ORIG_ROUTE(params, xg, cfg)
    return probs, torch.gather(probs, -1, idx), idx, pos, keep


_ORIG_ROUTE = moe.moe_route


@pytest.mark.parametrize("mutant", [_keep_last, _raw_gates])
def test_mutants_miss_the_tolerance(mutant, monkeypatch):
    """Tight capacity, f32: keeping the last ``cap`` tokens in place of the
    first, or skipping the gate renormalisation, lands far outside
    TOL_FFN_F32 (``moe_ffn`` looks ``moe_route`` up at call time)."""
    tp, cfg, x, want_y, _ = _ffn_case("float32", 0.25)
    assert _rel(moe.moe_ffn(tp, x, cfg)[0], want_y) <= TOL_FFN_F32
    monkeypatch.setattr(moe, "moe_route", mutant)
    assert _rel(moe.moe_ffn(tp, x, cfg)[0], want_y) > 100 * TOL_FFN_F32


# -- (c) reduced olmoe-1b-7b and qwen3-moe-30b-a3b ----------------------------

@functools.lru_cache(maxsize=None)
def _ref_forward(arch, policy):
    """The jitted reference forward of (2, 24) tokens: (tokens, logits,
    aux, routing)."""
    ref_cfg, cfg = _cfgs(arch, policy)
    toks = _tokens(cfg, (2, 24), 3)
    with _ref_routing() as routes:
        want, aux = jax.jit(lambda p, t: ref_T.forward(
            p, ref_cfg, {"tokens": t}))(_lm_params()[0], jnp.array(toks))
        jax.effects_barrier()
    return toks, np.asarray(want), float(aux), routes


#: (arch, policy, flash): reduced olmoe with the flash kernel off and on;
#: reduced qwen3, which differs from it only in ``rope_theta``, off.
FORWARD_CASES = [("olmoe-1b-7b", p, f) for p in ("fp32", "kom_int14")
                 for f in (False, True)] + [
    ("qwen3-moe-30b-a3b", p, False) for p in ("fp32", "kom_int14")]


@pytest.mark.parametrize("arch,policy,flash", FORWARD_CASES)
def test_forward_matches_jitted_reference(arch, policy, flash):
    """The port's forward with the flash kernel off and on (its plain
    version here, which ``test_torch_attention.py`` holds against the
    reference's Pallas kernel) against one jitted reference forward:
    the same routing first, then logits and aux."""
    _, tp = _lm_params()
    _, cfg = _cfgs(arch, policy, use_flash_kernel=flash)
    toks, want, want_aux, want_r = _ref_forward(arch, policy)
    with _port_routing() as got_r:
        got, aux = T.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    _same_routing(got_r, want_r)
    assert got.shape == (2, 24, cfg.padded_vocab)
    assert _rel(got, want) <= POLICIES[policy][1], _rel(got, want)
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert abs(float(aux) - want_aux) <= 1e-5 * want_aux


@pytest.mark.parametrize("policy", ["fp32", "kom_int14"])
def test_serve_step_matches_jitted_reference(policy):
    """Six decode steps on a shared 2-row cache, the second row writing
    every other step: the same routing, logits and cache within the
    policy's tolerance.  Reduced olmoe (reduced qwen3 differs in
    ``rope_theta`` alone, which its forward check covers)."""
    rp, tp = _lm_params()
    ref_cfg, cfg = _cfgs("olmoe-1b-7b", policy)
    b, max_len = 2, 16
    rcache = ref_T.init_cache(ref_cfg, b, max_len)
    cache = T.init_cache(cfg, b, max_len, device="cpu")
    step = jax.jit(lambda p, c, t, pos, m: ref_T.serve_step(
        p, ref_cfg, c, t, pos, write_mask=m))
    toks = _tokens(cfg, (b, 6), 5)
    tol = POLICIES[policy][1]
    n = cfg.n_layers
    with _ref_routing() as want_r, _port_routing() as got_r:
        for t in range(6):
            m = np.array([True, t % 2 == 0])
            rl, rcache = step(rp, rcache, jnp.array(toks[:, t:t + 1]),
                              jnp.int32(t), jnp.array(m))
            jax.effects_barrier()
            tl, cache = T.serve_step(tp, cfg, cache,
                                     torch.from_numpy(toks[:, t:t + 1]), t,
                                     write_mask=torch.from_numpy(m))
            assert len(want_r) == len(got_r) == n * (t + 1)
            _same_routing(got_r[-n:], want_r[-n:])
            assert _rel(tl, rl) <= tol, (t, _rel(tl, rl))
    for ours, theirs in ((cache["kv"].k, rcache["kv"].k),
                         (cache["kv"].v, rcache["kv"].v)):
        theirs = np.asarray(theirs, np.float32)
        assert (ours.numpy() == 0).sum() == (theirs == 0).sum()
        assert _rel(ours, theirs) <= tol


def _port_engine_tokens(cfg, tp, prompts, max_new, slots=2, max_len=32):
    eng = ServeEngine(cfg, tp, slots=slots, max_len=max_len, device="cpu")
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=max_new))
    done = eng.run()
    assert sorted(done) == list(range(len(prompts)))
    return {uid: done[uid].out_tokens for uid in done}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_engine_greedy_tokens_match_reference_engine(policy):
    """fp32 and kom_int14: the reference engine's greedy tokens exactly.
    native_bf16 (argmax is not continuous at bf16 resolution): every token
    the port emits within TOL_BF16 of the best logit of the reference's
    jitted serve_step, replaying the port's tokens one slot at a time as
    the engines feed them (``test_torch_lm.py``'s check).  The 2-slot
    decode group's capacity (4) exceeds what 2 rows can send to one
    expert, so nothing is dropped.  Reduced olmoe only: reduced qwen3
    differs from it in ``rope_theta`` alone, which the forward and
    serve_step checks cover."""
    rp, tp = _lm_params()
    ref_cfg, cfg = _cfgs("olmoe-1b-7b", policy)
    assert moe.moe_capacity(2, cfg.moe_top_k, cfg.moe_num_experts,
                            cfg.moe_capacity_factor) >= 2
    prompts = [_tokens(cfg, (n,), 10 + n) for n in (5, 3, 7)]
    max_new = 5
    got = _port_engine_tokens(cfg, tp, prompts, max_new)
    if policy != "native_bf16":
        eng = RefEngine(ref_cfg, rp, slots=2, max_len=32)
        for uid, p in enumerate(prompts):
            eng.submit(RefRequest(uid=uid, prompt=p, max_new_tokens=max_new))
        done = eng.run()
        assert {u: done[u].out_tokens for u in done} == got
        return
    step = jax.jit(lambda p, c, t, pos: ref_T.serve_step(p, ref_cfg, c, t,
                                                         pos))
    tol = POLICIES["native_bf16"][1]
    for uid, prompt in enumerate(prompts):
        seq = list(prompt) + [prompt[-1]] + got[uid]
        cache = ref_T.init_cache(ref_cfg, 1, 32)
        for t in range(len(seq) - 1):
            lg, cache = step(rp, cache, jnp.array([[seq[t]]], jnp.int32),
                             jnp.int32(t))
            row = np.asarray(lg, np.float32).reshape(-1)[:cfg.vocab_size]
            if t >= len(prompt):
                gap = row.max() - row[seq[t + 1]]
                assert gap <= tol * np.abs(row).max(), (uid, t, gap)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_decode_matches_forward(lm, policy):
    """The port's KV-cache decode reproduces its own teacher-forced forward
    (no drops: the forward's 20-token group has capacity 24, each decode
    step's 2-row group 4)."""
    arch, _, tp = lm
    _, cfg = _cfgs(arch, policy)
    b, s = 2, 10
    toks = torch.from_numpy(_tokens(cfg, (b, s), 6))
    with _port_routing() as routes:
        tf, _ = T.forward(tp, cfg, {"tokens": toks})
    assert all(keep.all() for _, keep in routes)
    cache = T.init_cache(cfg, b, s + 2, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = T.serve_step(tp, cfg, cache, toks[:, t:t + 1], t)
        outs.append(lg.reshape(b, -1))
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(dec[:, 1:].numpy(), tf[:, 1:].numpy(),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(dec[:, -1].argmax(-1), tf[:, -1].argmax(-1))


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", ["olmoe-1b-7b"])
def test_interleaved_batched_decode_matches_single_slot(arch, policy):
    """Staggered admission into a 2-slot engine == each request served
    alone in a 1-slot engine, token for token.  This holds only where the
    slots fit the decode group's capacity (``slots <= cap``): past it a
    request's expert can be full of its batch-mates' tokens.  Reduced
    olmoe (reduced qwen3's decode group and capacity are the same)."""
    _, tp = _lm_params()
    _, cfg = _cfgs(arch, policy)
    cap = moe.moe_capacity(2, cfg.moe_top_k, cfg.moe_num_experts,
                           cfg.moe_capacity_factor)
    assert 2 <= cap
    prompts = [_tokens(cfg, (n,), 20 + n) for n in (7, 3, 4)]
    max_new, max_len = 6, 64
    eng = ServeEngine(cfg, tp, slots=2, max_len=max_len, device="cpu")
    eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=max_new))
    for _ in range(3):
        eng.step()
    for uid, p in enumerate(prompts[1:], start=1):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=max_new))
    done = eng.run()
    for uid, prompt in enumerate(prompts):
        solo = _port_engine_tokens(cfg, tp, [prompt], max_new, slots=1,
                                   max_len=max_len)[0]
        assert done[uid].out_tokens == solo, uid


def test_decode_capacity_depends_on_batch_mates():
    """Full-width olmoe's decode group is every slot row: at 4 slots its
    capacity is 4 (no expert can overflow), at 8 slots still 4, so there
    a request can lose an expert to its batch-mates; the reduced config
    never drops in decode."""
    cfg = get_config("olmoe-1b-7b")
    cap = lambda rows: moe.moe_capacity(rows, cfg.moe_top_k,
                                        cfg.moe_num_experts,
                                        cfg.moe_capacity_factor)
    assert cap(4) == 4 and cap(8) == 4
    r = reduced(cfg)
    for rows in (1, 2, 4, 8, 16):
        assert moe.moe_capacity(rows, r.moe_top_k, r.moe_num_experts,
                                r.moe_capacity_factor) >= rows


def test_quantize_params_inline_leaves_experts_float():
    """Under kom_int14 only the attention projections and the untied head
    become QWeights (bitwise the reference's); the router and the experts
    stay float, as the reference's QUANT_LEAVES leave them."""
    rp, tp = _lm_params()
    want = ref_wq.quantize_params_inline(rp)
    got = quantize_params_inline(tp)
    for name in ("wq", "wk", "wv", "wo"):
        w, g = want["layers"]["attn"][name], got["layers"]["attn"][name]
        assert isinstance(g, QWeight)
        np.testing.assert_array_equal(g.values.numpy(), np.asarray(w.values))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
    assert isinstance(got["lm_head"], QWeight)
    np.testing.assert_array_equal(got["lm_head"].values.numpy(),
                                  np.asarray(want["lm_head"].values))
    assert sorted(got["layers"]["moe"]) == ["router", "wd", "wg", "wu"]
    for name, leaf in got["layers"]["moe"].items():
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32
        assert torch.equal(leaf, tp["layers"]["moe"][name])
        assert not hasattr(want["layers"]["moe"][name], "scale")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_reference(arch):
    """The port's ``init_params`` tree has the reference's paths and shapes
    (``jax.eval_shape``: nothing drawn), and the shared test params fit
    both archs."""
    ref_cfg, cfg = _cfgs(arch, "fp32")
    rp = jax.eval_shape(lambda key: ref_T.init_params(ref_cfg, key),
                        jax.random.PRNGKey(0))
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda a: a.shape, rp) == jax.tree.map(
        lambda a: a.shape, _lm_params()[0])
    flat_r = jax.tree_util.tree_flatten_with_path(rp)[0]
    flat_t = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(prefix + (k,), v)
        else:
            flat_t[prefix] = t
    walk((), tp)
    assert len(flat_r) == len(flat_t)
    for path, leaf in flat_r:
        key = tuple(p.key for p in path)
        assert tuple(flat_t[key].shape) == leaf.shape, key
    lm_moe = tp["layers"]["moe"]
    # N(0, 1/d) and N(0, 1/d_ff) draws
    assert abs(float(lm_moe["wg"].std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(float(lm_moe["wd"].std()) * cfg.d_ff ** 0.5 - 1) < 0.05


def test_launcher_serves_olmoe_on_cpu(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--slots", "2", "--max-new", "3",
                 "--policy", "kom_int14"]) == 0
    assert "olmoe-1b-7b/kom_int14 on cpu: 3 requests" in \
        capsys.readouterr().out


# -- (d) twins of tests/test_moe_properties.py --------------------------------

def _prop_cfgs(e=8, k=2, gsz=32, cf=4.0):
    kw = dict(moe_num_experts=e, moe_top_k=k, moe_group_size=gsz,
              moe_capacity_factor=cf, d_ff=16)
    return (ref_reduced(ref_get_config("olmoe-1b-7b")).replace(**kw),
            reduced(get_config("olmoe-1b-7b")).replace(**kw))


@pytest.mark.parametrize("seed,k,e", [(0, 1, 4), (7, 3, 8), (11, 4, 16)])
def test_moe_output_finite_and_aux_matches_reference(seed, k, e):
    """Finite output of the input's shape, and the aux loss equal to the
    reference's on the same params and input (not ``aux >= 0.99``: that
    bound has a real counterexample, 0.98371)."""
    ref_cfg, cfg = _prop_cfgs(e=e, k=k)
    tp = moe.moe_init(torch.Generator().manual_seed(seed), cfg)
    rp = {name: jnp.array(t.numpy()) for name, t in tp.items()}
    x = (np.random.default_rng(seed).standard_normal(
        (2, 16, cfg.d_model)) * 0.5).astype(np.float32)
    want_y, want_aux = jax.jit(lambda p, v: ref_moe.moe_ffn(p, v, ref_cfg))(
        rp, jnp.array(x))
    y, aux = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert abs(float(aux) - float(want_aux)) <= TOL_AUX * float(want_aux)
    assert _rel(y, want_y) <= TOL_FFN_F32


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_moe_permutation_equivariance(seed):
    """Permuting tokens within a group permutes outputs identically
    (capacity generous enough that no drops occur)."""
    _, cfg = _prop_cfgs(gsz=16, cf=8.0)
    tp = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, 16, cfg.d_model)).astype(
        np.float32))
    perm = rng.permutation(16)
    y1, _ = moe.moe_ffn(tp, x, cfg)
    y2, _ = moe.moe_ffn(tp, x[:, perm], cfg)
    np.testing.assert_allclose(y1[:, perm].numpy(), y2.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_moe_capacity_formula():
    assert moe.moe_capacity(512, 8, 128, 1.25) % 4 == 0
    assert moe.moe_capacity(512, 8, 128, 1.25) >= 512 * 8 * 1.25 / 128
    assert moe.moe_capacity(2, 1, 64, 1.0) == 4  # floor
    for args in ((512, 8, 64, 1.25), (4, 8, 64, 1.25), (64, 2, 8, 4.0),
                 (48, 2, 8, 0.25), (1, 8, 128, 1.25), (2048, 8, 128, 1.25)):
        assert moe.moe_capacity(*args) == ref_moe.moe_capacity(*args), args


def test_moe_drops_tokens_when_capacity_tight():
    """With capacity << demand, dropped tokens' outputs are exactly zero
    (the residual path alone) and everything stays finite."""
    _, cfg = _prop_cfgs(gsz=32, cf=0.25)
    tp = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 32, cfg.d_model)).astype(np.float32))
    y, _ = moe.moe_ffn(tp, x, cfg)
    assert (y[0].norm(dim=-1) == 0).any()
    assert torch.isfinite(y).all()
