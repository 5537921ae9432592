"""The port's dense LM family against the JAX reference, on the CPU.

The reference builds the params (``transformer.init_params``) and
``repro_torch.convert.lm_params_from_numpy`` carries them across; the same
tokens (numpy, seeded) go through ``jax.jit`` of the reference's functions
and through the port's plain versions.

XLA:CPU's ``exp``, ``rsqrt``, ``pow`` and dot order are not torch's, so the
LM is held to tolerances even under the integer policies (an ulp in an
activation can move a 14-bit quantization level), each stated as a
fraction of max |logit|:

* ``fp32`` (f32 compute): :data:`TOL_FP32`, with a mutant control (causal
  ``>`` for ``>=`` in the flash kernel's plain version) that must miss it;
* ``kom_int14`` (f32 compute): :data:`TOL_KOM` -- one moved level in a
  (k=64) row moves an output by ~1/8127 of its scale;
* ``native_bf16`` (bf16 compute, the configs' default): :data:`TOL_BF16`,
  a few bf16 ulps (the reference's own decode-vs-forward test uses 2e-2).

The integer pieces are exact given the same inputs, and are tested so:
``quantize_params_inline`` values and scales, ``kom_q_dot`` and one
``dense`` under ``kom_int14``, bit for bit.
"""
import contextlib
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import precision as ref_precision  # noqa: E402
from repro.core.precision import MatmulPolicy as RefPolicy  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.serving import weight_quant as ref_wq  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core.precision import MatmulPolicy, kom_q_dot  # noqa: E402
from repro_torch.core.substrate import QWeight  # noqa: E402
from repro_torch.launch import step_fns  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serving.weight_quant import quantize_params_inline  # noqa: E402
from test_torch_refcache import (init_numpy,  # noqa: E402
                                 refcache_session)  # noqa: F401

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
TOL_FP32 = 1e-5
TOL_KOM = 2e-3
TOL_BF16 = 3e-2
#: The port's kom_q_dot against the reference's JITTED one (see the test).
KOM_Q_JIT_TOL = 1e-4
#: policy -> (compute dtype, tolerance on max|diff| / max|logit|)
POLICIES = {"fp32": ("float32", TOL_FP32), "kom_int14": ("float32", TOL_KOM),
            "native_bf16": ("bfloat16", TOL_BF16)}
FAMILY_ARCHS = ["granite-3-2b", "deepseek-7b"]   # tied and untied head
FA_MOD = "repro_torch.kernels.flash_attention.flash_attention"


def _cfgs(arch, policy, **kw):
    cd = POLICIES[policy][0]
    ref = ref_reduced(ref_get_config(arch)).replace(
        policy=RefPolicy(policy), compute_dtype=cd, **kw)
    port = reduced(get_config(arch)).replace(
        policy=MatmulPolicy(policy), compute_dtype=cd, **kw)
    return ref, port


def _params(ref_cfg, seed=1):
    """The reference's params (drawn once per run, ``test_torch_refcache``)
    and the port's copy."""
    tree = init_numpy("lm-init", (repr(ref_cfg), seed), lambda:
                      ref_T.init_params(ref_cfg, jax.random.PRNGKey(seed)))
    return (jax.tree.map(jnp.asarray, tree),
            lm_params_from_numpy(tree, device="cpu"))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@contextlib.contextmanager
def _strict_causal_plain():
    """The flash kernel's plain version with causal ``>`` for ``>=`` (the
    diagonal key masked): the mutant control."""
    mod = importlib.import_module(FA_MOD)
    orig = mod.live_mask

    def live(q_pos, k_pos, *, causal, window):
        m = orig(q_pos, k_pos, causal=causal, window=window)
        return m & (q_pos[:, None] != k_pos[None, :]) if causal else m
    mod.live_mask = live
    try:
        yield
    finally:
        mod.live_mask = orig


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, shape).astype(np.int32)


# -- configs ------------------------------------------------------------------

def test_registry_matches_reference():
    assert ARCHS == sorted(REF_ARCHS)
    for arch in ARCHS:
        ref, port = ref_get_config(arch), get_config(arch)
        for cfg_r, cfg_p in ((ref, port), (ref_reduced(ref), reduced(port))):
            for f in cfg_p.__dataclass_fields__:
                want = getattr(cfg_r, f)
                want = getattr(want, "value", want)
                got = getattr(cfg_p, f)
                assert getattr(got, "value", got) == want, (arch, f)
            assert cfg_p.padded_vocab == cfg_r.padded_vocab
    assert get_config("granite-3-2b").dtype == torch.bfloat16
    assert get_config("granite-3-2b").padded_vocab == 49408


@pytest.mark.parametrize("arch", ARCHS)
def test_every_lm_arch_runs_reduced(arch):
    """Every LM arch of the registry builds, runs ``forward`` and
    ``init_cache`` reduced on the CPU (each family's embeddings beside the
    tokens): finite logits of the padded vocab, and the reference's
    ``init_cache`` leaf for leaf (shapes, dtypes, values)."""
    cfg = reduced(get_config(arch)).replace(compute_dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (2, 6), generator=g)}
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.randn((2, cfg.n_img_tokens,
                                           cfg.d_model), generator=g)
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.randn((2, cfg.enc_seq, cfg.d_model),
                                            generator=g)
    logits, _ = T.forward(params, cfg, batch)
    assert logits.shape == (2, 6, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    want = jax.tree.leaves(ref_T.init_cache(
        ref_reduced(ref_get_config(arch)).replace(compute_dtype="float32"),
        2, 8))
    got = jax.tree.leaves(T.init_cache(cfg, 2, 8, device="cpu"))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert str(g.dtype) == f"torch.{w.dtype}"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unknown_family_raises_value_error():
    """As in the reference, a family the zoo does not know is a
    ``ValueError`` at every entry point."""
    cfg = reduced(get_config("granite-3-2b")).replace(family="rwkv")
    with pytest.raises(ValueError, match="rwkv"):
        T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="rwkv"):
        T.forward({"embed": torch.zeros((256, 64))}, cfg,
                  {"tokens": torch.zeros((1, 2), dtype=torch.long)})
    with pytest.raises(ValueError, match="rwkv"):
        T.init_cache(cfg, 1, 8, device="cpu")


# -- the integer pieces, bit for bit ------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_quantize_params_inline_bitwise(arch):
    ref_cfg, _ = _cfgs(arch, "kom_int14")
    rp, tp = _params(ref_cfg)
    want = ref_wq.quantize_params_inline(rp)
    got = quantize_params_inline(tp)
    n = 0
    for name in ("wq", "wk", "wv", "wo"):
        w, g = want["layers"]["attn"][name], got["layers"]["attn"][name]
        assert isinstance(g, QWeight) and g.scale.shape == w.scale.shape
        np.testing.assert_array_equal(g.values.numpy(), np.asarray(w.values))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
        n += 1
    for name in ("w_gate", "w_up", "w_down"):
        w, g = want["layers"]["mlp"][name], got["layers"]["mlp"][name]
        np.testing.assert_array_equal(g.values.numpy(), np.asarray(w.values))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
        n += 1
    if "lm_head" in want:
        np.testing.assert_array_equal(got["lm_head"].values.numpy(),
                                      np.asarray(want["lm_head"].values))
        np.testing.assert_array_equal(got["lm_head"].scale.numpy(),
                                      np.asarray(want["lm_head"].scale))
    assert n == 7
    # the embedding and norms stay float (embed is not a QUANT_LEAF)
    assert not isinstance(got["embed"], QWeight)
    np.testing.assert_array_equal(got["embed"].numpy(),
                                  np.asarray(want["embed"]))


@pytest.mark.parametrize("m,k,n,scale", [(6, 64, 96, 1.0), (1, 300, 7, 1e-3),
                                         (33, 2048, 40, 50.0),
                                         (29, 283, 88, 3.0)])
def test_kom_q_dot_bitwise_vs_reference(m, k, n, scale):
    """Both operands quantized per tensor (true-division scales), the exact
    limb product, times s_a * s_b: the reference's eager ``_kom_q_dot``
    bit for bit.  Its jitted form rounds differently from shape to shape
    (XLA's rewrites; no single rule reproduces it), so against that the
    port is held to KOM_Q_JIT_TOL of max |out|, which a wrong limb
    schedule (every pass but one) misses."""
    r = np.random.default_rng(m + k + n)
    a = (r.standard_normal((m, k)) * scale).astype(np.float32)
    b = r.standard_normal((k, n)).astype(np.float32)
    eager = ref_precision._kom_q_dot(jnp.array(a), jnp.array(b), 7,
                                     "karatsuba")
    jitted = jax.jit(lambda x, y: ref_precision._kom_q_dot(
        x, y, 7, "karatsuba"))(jnp.array(a), jnp.array(b))
    got = kom_q_dot(torch.from_numpy(a), torch.from_numpy(b),
                    variant="karatsuba", base_bits=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(eager))
    assert _rel(got, jitted) <= KOM_Q_JIT_TOL
    from repro_torch.core import substrate
    p_hh, p_mid, p_ll = (t.numpy() for t in substrate.limb_partials(
        torch.from_numpy(np.clip(np.round(a / (np.abs(a).max() / 8127)),
                                 -8127, 8127).astype(np.int32)),
        torch.from_numpy(np.clip(np.round(b / (np.abs(b).max() / 8127)),
                                 -8127, 8127).astype(np.int32))))
    sab = np.float32(np.abs(a).max() / 8127) * np.float32(
        np.abs(b).max() / 8127)
    wrong = (p_hh.astype(np.float32) * 16384 + p_mid * 128) * sab
    assert _rel(wrong, jitted) > KOM_Q_JIT_TOL


def test_kom_q_dot_refuses_gradients():
    a = torch.randn((2, 8), requires_grad=True)
    with pytest.raises(NotImplementedError, match="straight-through"):
        kom_q_dot(a, torch.randn((8, 3)), variant="karatsuba", base_bits=7)


@pytest.mark.parametrize("prequant", [True, False])
@pytest.mark.parametrize("bias", [False, True])
def test_dense_under_kom_int14_bitwise(prequant, bias):
    """One ``dense`` under kom_int14.  Cached QWeight: per-row activation
    quant, the bias as one FMA -- the jitted reference bit for bit.  Float
    weight: both operands per tensor -- without a bias the eager reference
    bit for bit (eagerly a bias is a second rounding; the port fuses it as
    one FMA, as the jitted forward does); either way the jitted one within
    KOM_Q_JIT_TOL (see the test above)."""
    r = np.random.default_rng(5)
    x = r.standard_normal((3, 5, 64)).astype(np.float32)
    w = (r.standard_normal((64, 48)) * 0.1).astype(np.float32)
    bvec = r.standard_normal((48,)).astype(np.float32) if bias else None
    pol = "kom_int14"
    if prequant:
        rw = ref_wq.quantize_params_inline({"wq": jnp.array(w)})["wq"]
        tw = quantize_params_inline({"wq": torch.from_numpy(w)})["wq"]
    else:
        rw, tw = jnp.array(w), torch.from_numpy(w)
    ref = lambda xx, ww, bb: ref_layers.dense(xx, ww, policy=RefPolicy(pol),
                                              bias=bb)
    args = (jnp.array(x), rw, None if bvec is None else jnp.array(bvec))
    got = layers.dense(torch.from_numpy(x), tw, policy=MatmulPolicy(pol),
                       bias=None if bvec is None else torch.from_numpy(bvec))
    jitted = np.asarray(jax.jit(ref)(*args))
    if prequant:
        np.testing.assert_array_equal(got.numpy(), jitted)
    else:
        if not bias:
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(ref(*args)))
        assert _rel(got, jitted) <= KOM_Q_JIT_TOL


# -- whole models ---------------------------------------------------------------

@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_matches_jitted_reference(arch, policy, flash):
    ref_cfg, cfg = _cfgs(arch, policy, use_flash_kernel=flash)
    rp, tp = _params(ref_cfg)
    toks = _tokens(cfg, (2, 24), 3)
    want, _ = jax.jit(lambda p, t: ref_T.forward(p, ref_cfg, {"tokens": t})
                      )(rp, jnp.array(toks))
    got, aux = T.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert got.shape == (2, 24, cfg.padded_vocab)
    tol = POLICIES[policy][1]
    assert _rel(got, want) <= tol, _rel(got, want)
    if flash and policy == "fp32":
        with _strict_causal_plain():
            bad, _ = T.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
        assert _rel(bad, want) > tol


def test_prefill_step_and_collect_kv_match_reference():
    ref_cfg, cfg = _cfgs("granite-3-2b", "fp32")
    rp, tp = _params(ref_cfg)
    toks = _tokens(cfg, (2, 12), 4)
    want = jax.jit(lambda p, t: ref_T.forward(p, ref_cfg, {"tokens": t})[0]
                   )(rp, jnp.array(toks))
    got = step_fns.make_prefill_step(cfg)(tp, {"tokens": torch.from_numpy(
        toks)})
    assert _rel(got, want) <= TOL_FP32
    x = ref_T._embed(rp, ref_cfg, jnp.array(toks))
    _, _, (rk, rv) = ref_T._dense_stack_forward(rp, ref_cfg, x,
                                                jnp.arange(12),
                                                collect_kv=True)
    with torch.inference_mode():
        _, _, (k, v) = T._dense_stack_forward(
            tp, cfg, T._embed(tp, cfg, torch.from_numpy(toks).long()),
            torch.arange(12), collect_kv=True)
    assert k.shape == rk.shape and v.shape == rv.shape
    assert _rel(k, rk) <= TOL_FP32 and _rel(v, rv) <= TOL_FP32
    with pytest.raises(NotImplementedError,
                       match="Queue 1, training and distribution"):
        step_fns.make_train_step(cfg)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serve_step_matches_jitted_reference(arch, policy):
    """Six decode steps on a shared 2-row cache, the second row writing
    every other step (write mask): logits and the cache within the
    policy's tolerance of the jitted reference."""
    ref_cfg, cfg = _cfgs(arch, policy)
    rp, tp = _params(ref_cfg)
    b, max_len = 2, 16
    rcache = ref_T.init_cache(ref_cfg, b, max_len)
    cache = T.init_cache(cfg, b, max_len, device="cpu")
    step = jax.jit(lambda p, c, t, pos, m: ref_T.serve_step(
        p, ref_cfg, c, t, pos, write_mask=m))
    toks = _tokens(cfg, (b, 6), 5)
    step_fn = step_fns.make_serve_step(cfg)
    tol = POLICIES[policy][1]
    for t in range(6):
        m = np.array([True, t % 2 == 0])
        rl, rcache = step(rp, rcache, jnp.array(toks[:, t:t + 1]),
                          jnp.int32(t), jnp.array(m))
        if t == 0:
            tl, _ = step_fn(tp, cache, torch.from_numpy(toks[:, :1]), 0)
            assert tl.shape == (b, 1, cfg.padded_vocab)
        tl, cache = T.serve_step(tp, cfg, cache,
                                 torch.from_numpy(toks[:, t:t + 1]), t,
                                 write_mask=torch.from_numpy(m))
        assert _rel(tl, rl) <= tol, (t, _rel(tl, rl))
    for ours, theirs in ((cache["kv"].k, rcache["kv"].k),
                         (cache["kv"].v, rcache["kv"].v)):
        theirs = np.asarray(theirs, np.float32)
        assert (np.asarray(ours.float()) == 0).sum() == (theirs == 0).sum()
        assert _rel(ours.float(), theirs) <= tol


def test_write_mask_protects_other_rows():
    """serve_step with a write mask leaves masked-out rows' cache bit for
    bit; the raw (maskless) step overwrites them."""
    _, cfg = _cfgs("granite-3-2b", "fp32")
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    for t in range(3):
        tok = torch.tensor([[5 + t], [0]])
        _, cache = T.serve_step(tp, cfg, cache, tok, t,
                                write_mask=torch.tensor([True, False]))
    kv = cache["kv"]
    assert kv.k[:, 0, :, :3].abs().sum() > 0
    assert kv.k[:, 1].abs().sum() == 0
    tok = torch.tensor([[0], [9]])
    _, masked = T.serve_step(tp, cfg, cache, tok, 0,
                             write_mask=torch.tensor([False, True]))
    assert torch.equal(masked["kv"].k[:, 0], kv.k[:, 0])
    assert masked["kv"].k[:, 1, :, 0].abs().sum() > 0
    _, raw = T.serve_step(tp, cfg, cache, tok, 0)
    assert (raw["kv"].k[:, 0, :, 0] - kv.k[:, 0, :, 0]).abs().sum() > 0


def test_cache_tree_maps_cover_every_leaf():
    """``serve_step``'s write mask and ``ServeEngine._reset_rows`` walk every
    cache leaf -- dicts and NamedTuples, the dense ``kv`` and the xLSTM
    ``groups`` alike -- as the reference's ``jax.tree.map`` does: masked
    rows keep their old value; a reset row returns to the pristine cache
    (the sLSTM normalizer to ones, not zeros)."""
    from repro_torch.models.ssm import MLSTMState, SLSTMState

    def tree(fill):
        full = lambda *shape: torch.full(shape, float(fill))
        return {"kv": KVCache(full(2, 3, 1, 4, 2), full(2, 3, 1, 4, 2)),
                "groups": {"b0": MLSTMState(full(1, 3, 2, 4, 4),
                                            full(1, 3, 2, 4),
                                            full(1, 3, 3, 8)),
                           "b1": SLSTMState(full(1, 3, 8), full(1, 3, 8),
                                            full(1, 3, 8) * 0 + 1)}}
    mask = torch.tensor([True, False, True])
    m = lambda a: mask.reshape((1, -1) + (1,) * (a.ndim - 2))
    kept = T.map_tree(lambda new, old: torch.where(m(new), new, old),
                       tree(7), tree(5))
    leaves = [kept["kv"].k, kept["kv"].v, *kept["groups"]["b0"],
              *kept["groups"]["b1"][:2]]
    assert type(kept["groups"]["b1"]) is SLSTMState and len(leaves) == 7
    for leaf in leaves:
        assert (leaf[:, 0] == 7).all() and (leaf[:, 1] == 5).all()
    eng = ServeEngine.__new__(ServeEngine)
    eng.cache, eng._cache0 = tree(9), tree(0)
    eng._reset_rows(torch.tensor([False, True, False]))
    n = eng.cache["groups"]["b1"].n
    assert (n[:, 1] == 1).all() and (n[:, 0] == 1).all()
    for leaf in (eng.cache["kv"].k, *eng.cache["groups"]["b0"],
                 eng.cache["groups"]["b1"].h):
        assert (leaf[:, 1] == 0).all() and (leaf[:, 0] == 9).all()


# -- the serving engine ---------------------------------------------------------

def _port_engine_tokens(cfg, tp, prompts, max_new, slots=2, max_len=32):
    eng = ServeEngine(cfg, tp, slots=slots, max_len=max_len, device="cpu")
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=max_new))
    done = eng.run()
    assert sorted(done) == list(range(len(prompts)))
    assert eng.stats()["requests_done"] == len(prompts)
    return {uid: done[uid].out_tokens for uid in done}


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_engine_greedy_tokens_match_reference_engine(arch, policy):
    """fp32 and kom_int14 (f32 compute): the port's ServeEngine emits the
    reference engine's greedy tokens exactly.  native_bf16: argmax is not
    continuous at bf16 resolution, so every token the port emits is checked
    instead to be within TOL_BF16 (of max |logit|) of the best logit of the
    REFERENCE's jitted serve_step, replaying the port's tokens one slot at
    a time as the engines feed them (the prompt, then its last token again
    at the next position, then each emitted token)."""
    ref_cfg, cfg = _cfgs(arch, policy)
    rp, tp = _params(ref_cfg)
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
    for uid, prompt in enumerate(prompts):
        seq = list(prompt) + [prompt[-1]] + got[uid]
        cache = ref_T.init_cache(ref_cfg, 1, 32)
        for t in range(len(seq) - 1):
            lg, cache = step(rp, cache, jnp.array([[seq[t]]], jnp.int32),
                             jnp.int32(t))
            row = np.asarray(lg, np.float32).reshape(-1)[:cfg.vocab_size]
            if t >= len(prompt):
                gap = row.max() - row[seq[t + 1]]
                assert gap <= TOL_BF16 * np.abs(row).max(), (uid, t, gap)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_matches_forward(arch, policy):
    """The port's KV-cache decode reproduces its own teacher-forced
    forward (as tests/test_decode_consistency.py holds the reference)."""
    _, cfg = _cfgs(arch, policy)
    tp = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    b, s = 2, 10
    toks = torch.from_numpy(_tokens(cfg, (b, s), 6))
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


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_interleaved_batched_decode_matches_single_slot(arch, policy):
    """Staggered admission into a 2-slot engine == each request served
    alone in a 1-slot engine, token for token (greedy)."""
    _, cfg = _cfgs(arch, policy)
    tp = T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
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


def test_engine_refuses_faults_and_a_missing_gpu():
    """A FaultPlan is accepted now (fault injection is ported: the engine
    wraps it in an injector on its clock); a missing GPU is still refused
    unless the caller asks for the CPU."""
    from repro_torch.serving.faults import FaultInjector, FaultPlan
    _, cfg = _cfgs("granite-3-2b", "fp32")
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, tp, device="cpu", faults=FaultPlan(seed=3),
                      clock=lambda: 7.0)
    assert isinstance(eng.faults, FaultInjector)
    assert eng.faults.plan == FaultPlan(seed=3)
    assert eng.request_queue.now() == 7.0
    assert eng.stats()["faults"] == {
        "seed": 3, "injected": {"transient": 0, "poison": 0, "oom": 0,
                                "latency": 0}, "clock_skew_s": 0.0}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(cfg, tp)


def test_engine_kom_int14_prequantizes_once():
    _, cfg = _cfgs("deepseek-7b", "kom_int14")
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, tp, slots=2, max_len=16, device="cpu")
    assert isinstance(eng.params["layers"]["attn"]["wq"], QWeight)
    assert isinstance(eng.params["lm_head"], QWeight)
    assert eng.params["layers"]["attn"]["wq"].scale.shape == \
        (cfg.n_layers, 1, cfg.n_heads * cfg.head_dim)


def test_lm_launcher_on_cpu(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--slots", "2", "--max-new", "3",
                 "--policy", "kom_int14"]) == 0
    out = capsys.readouterr().out
    assert "granite-3-2b/kom_int14 on cpu: 3 requests" in out
    with pytest.raises(SystemExit):
        main(["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
              "--explore"])


def test_importing_the_lm_side_loads_no_jax():
    code = ("import sys, repro_torch.models.transformer,"
            " repro_torch.serving.engine, repro_torch.launch.step_fns,"
            " repro_torch.kernels.flash_attention,"
            " repro_torch.kernels.flash_decode, repro_torch.configs,"
            " repro_torch.models.ssm, repro_torch.kernels.mlstm_chunk,"
            " repro_torch.analysis.roofline;"
            " bad = [m for m in sys.modules if m == 'jax' or m == 'repro'"
            " or m.startswith(('jax.', 'repro.'))];"
            " assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
