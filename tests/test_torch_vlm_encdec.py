"""The port's VLM and encoder-decoder families against the JAX reference,
on the CPU: reduced ``internvl2-26b`` (the dense stack with 4 image
positions) and ``whisper-large-v3`` (2 encoder and 2 decoder layers over
16 frame embeddings).

The reference builds the params (``transformer.init_params``, once a run
through ``test_torch_refcache``) and ``repro_torch.convert`` carries them
across; the same tokens and embeddings (numpy, seeded) go through
``jax.jit`` of the reference's functions and through the port's plain
versions, within the tolerances of ``tests/test_torch_lm.py`` (of max
|logit|): ``fp32`` 1e-5, ``kom_int14`` 2e-3, ``native_bf16`` 3e-2.  With
``use_flash_kernel=True`` the reference runs its Pallas kernel in
interpret mode, the port the kernel's plain version.
"""
import contextlib
import importlib

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
from repro.models import transformer as ref_T  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core.precision import MatmulPolicy  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import step_fns  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from test_torch_refcache import (cached, digest, init_numpy,  # noqa: E402
                                 refcache_session)  # noqa: F401

VLM, ENCDEC = "internvl2-26b", "whisper-large-v3"
ARCHS2 = [VLM, ENCDEC]
TOL_FP32 = 1e-5
TOL_KOM = 2e-3
TOL_BF16 = 3e-2
#: policy -> (compute dtype, tolerance on max|diff| / max|logit|)
POLICIES = {"fp32": ("float32", TOL_FP32), "kom_int14": ("float32", TOL_KOM),
            "native_bf16": ("bfloat16", TOL_BF16)}
FA_MOD = "repro_torch.kernels.flash_attention.flash_attention"


def _cfgs(arch, policy, **kw):
    cd = POLICIES[policy][0]
    ref = ref_reduced(ref_get_config(arch)).replace(
        policy=RefPolicy(policy), compute_dtype=cd, **kw)
    port = reduced(get_config(arch)).replace(
        policy=MatmulPolicy(policy), compute_dtype=cd, **kw)
    return ref, port


def _params(arch, seed=1):
    """The reference's params (drawn once per run; they depend on neither
    the policy nor the compute dtype) and the port's copy."""
    ref_cfg = ref_reduced(ref_get_config(arch))
    tree = init_numpy("lm-init", (repr(ref_cfg), seed), lambda:
                      ref_T.init_params(ref_cfg, jax.random.PRNGKey(seed)))
    return (jax.tree.map(jnp.asarray, tree),
            lm_params_from_numpy(tree, device="cpu"))


def _batch(cfg, b, s, seed):
    """Seeded tokens and, for the family, its embeddings (numpy)."""
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(1, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["img_embeds"] = r.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["audio_embeds"] = r.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


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


@contextlib.contextmanager
def _strict_causal_plain():
    """The flash kernel's plain version with causal ``>`` for ``>=``: the
    mutant control."""
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


# -- params -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS2)
def test_param_trees_match_reference(arch):
    """The port's ``init_params`` makes the reference's tree (names,
    shapes, dtypes, also under a bf16 ``param_dtype``), and ``convert``
    carries the reference's tree across leaf for leaf, bit for bit."""
    rp, tp = _params(arch)
    ref_leaves = _flat(jax.tree.map(np.asarray, rp))
    assert set(_flat(tp)) == set(ref_leaves)
    for name, t in _flat(tp).items():
        np.testing.assert_array_equal(t.numpy(), ref_leaves[name])
    for pdt in ("float32", "bfloat16"):
        ref_cfg = ref_reduced(ref_get_config(arch)).replace(param_dtype=pdt)
        cfg = reduced(get_config(arch)).replace(param_dtype=pdt)
        want = _flat(jax.eval_shape(lambda: ref_T.init_params(
            ref_cfg, jax.random.PRNGKey(0))))
        got = _flat(T.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"))
        assert set(got) == set(want)
        for name, t in got.items():
            assert tuple(t.shape) == want[name].shape, name
            assert str(t.dtype) == f"torch.{want[name].dtype}", name
    names = set(ref_leaves)
    if arch == ENCDEC:
        assert {"enc_final_norm/w", "enc_final_norm/b",
                "dec_layers/xattn/bk", "dec_layers/norm_x/w",
                "enc_layers/mlp/b_up", "dec_layers/mlp/b_down"} <= names
        assert not any(n.startswith("layers/") for n in names)
    else:
        assert "lm_head" in names and "layers/mlp/w_gate" in names


# -- whole models -------------------------------------------------------------

def _ref_forward(ref_cfg, rp, batch):
    """``jax.jit`` of the reference's forward, once a run."""
    return cached("vlm-encdec-forward", (repr(ref_cfg), digest(batch)),
                  lambda: np.asarray(jax.jit(
                      lambda p, b: ref_T.forward(p, ref_cfg, b)[0])(
                          rp, _ref(batch))))


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", ARCHS2)
def test_forward_matches_jitted_reference(arch, policy, flash):
    """Both families, each policy, the flash kernel off and on (whisper's
    16 frames fill one key block, so its non-causal encoder runs the
    kernel too); under fp32 with the kernel the strict-causal mutant of
    its plain version (the decoder is causal) must miss."""
    ref_cfg, cfg = _cfgs(arch, policy, use_flash_kernel=flash)
    rp, tp = _params(arch)
    batch = _batch(cfg, 2, 12, 3)
    want = _ref_forward(ref_cfg, rp, batch)
    got, aux = T.forward(tp, cfg, _port(batch))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert got.shape == (2, 12, cfg.padded_vocab)
    tol = POLICIES[policy][1]
    assert _rel(got, want) <= tol, _rel(got, want)
    if flash and policy == "fp32":
        with _strict_causal_plain():
            bad, _ = T.forward(tp, cfg, _port(batch))
        assert _rel(bad, want) > tol


@pytest.mark.parametrize("arch", ARCHS2)
def test_step_fns_pass_the_embeddings(arch):
    """``make_prefill_step`` hands the whole batch (tokens and the
    family's embeddings) to ``forward``, as the reference's does; without
    the embeddings both packages' forwards fail alike."""
    _, cfg = _cfgs(arch, "fp32")
    _, tp = _params(arch)
    batch = _port(_batch(cfg, 2, 8, 4))
    want, _ = T.forward(tp, cfg, batch)
    got = step_fns.make_prefill_step(cfg)(tp, batch)
    assert torch.equal(got, want)
    with pytest.raises(KeyError):
        step_fns.make_prefill_step(cfg)(tp, {"tokens": batch["tokens"]})


def test_image_positions_do_not_reach_the_logits():
    """The image embeddings REPLACE the first ``n_img_tokens`` token
    embeddings: other token ids there give the same logits bit for bit,
    another id after them does not."""
    _, cfg = _cfgs(VLM, "fp32")
    _, tp = _params(VLM)
    batch = _port(_batch(cfg, 2, 10, 5))
    want, _ = T.forward(tp, cfg, batch)
    other = dict(batch, tokens=batch["tokens"].clone())
    other["tokens"][:, :cfg.n_img_tokens] = torch.flip(
        other["tokens"][:, :cfg.n_img_tokens], dims=(1,)) + 1
    got, _ = T.forward(tp, cfg, other)
    assert torch.equal(got, want)
    other["tokens"][:, cfg.n_img_tokens] += 1
    moved, _ = T.forward(tp, cfg, other)
    assert not torch.equal(moved[:, cfg.n_img_tokens:],
                           want[:, cfg.n_img_tokens:])


# -- encode and decode --------------------------------------------------------

def _ref_encode(ref_cfg, rp, audio, b, max_len):
    def run():
        cache = jax.jit(lambda p, a: ref_T.encode(
            p, ref_cfg, a, ref_T.init_cache(ref_cfg, b, max_len)))(
                rp, jnp.asarray(audio))
        return jax.tree.map(np.asarray, cache)
    return cached("encdec-encode", (repr(ref_cfg), max_len, digest(audio)),
                  run)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_encode_cross_kv_matches_reference(policy):
    """``encode``: every decoder layer's cross K/V of the encoder output,
    (L, b, hkv, enc_seq, dh) in the compute dtype, within the policy's
    tolerance of the jitted reference's; the self-attention cache stays
    zero and the input cache unchanged."""
    ref_cfg, cfg = _cfgs(ENCDEC, policy)
    rp, tp = _params(ENCDEC)
    audio = _batch(cfg, 2, 1, 6)["audio_embeds"]
    want = _ref_encode(ref_cfg, rp, audio, 2, 8)
    cache = T.init_cache(cfg, 2, 8, device="cpu")
    got = T.encode(tp, cfg, torch.from_numpy(audio), cache)
    assert not cache["cross_kv"].k.any()
    tol = POLICIES[policy][1]
    for ours, theirs in zip(got["cross_kv"], want["cross_kv"]):
        assert ours.shape == (cfg.n_layers, 2, cfg.n_kv_heads, cfg.enc_seq,
                              cfg.head_dim) == theirs.shape
        assert ours.dtype == cfg.dtype
        assert _rel(ours.float(), theirs) <= tol, _rel(ours.float(), theirs)
    assert not got["kv"].k.any() and not got["kv"].v.any()


@pytest.mark.parametrize("policy", list(POLICIES))
def test_whisper_serve_step_matches_jitted_reference(policy):
    """``encode``, then six decode steps on a shared 2-row cache, the
    second row writing every other step (write mask): logits and the
    self-attention cache within the policy's tolerance of the jitted
    reference's, and ``cross_kv`` passed through unchanged."""
    ref_cfg, cfg = _cfgs(ENCDEC, policy)
    rp, tp = _params(ENCDEC)
    b, max_len = 2, 16
    batch = _batch(cfg, b, 6, 7)
    rcache = jax.tree.map(jnp.asarray, _ref_encode(
        ref_cfg, rp, batch["audio_embeds"], b, max_len))
    cache = T.encode(tp, cfg, torch.from_numpy(batch["audio_embeds"]),
                     T.init_cache(cfg, b, max_len, device="cpu"))
    cross = cache["cross_kv"]
    step = jax.jit(lambda p, c, t, pos, m: ref_T.serve_step(
        p, ref_cfg, c, t, pos, write_mask=m))
    toks = batch["tokens"]
    tol = POLICIES[policy][1]
    for t in range(6):
        m = np.array([True, t % 2 == 0])
        rl, rcache = step(rp, rcache, jnp.array(toks[:, t:t + 1]),
                          jnp.int32(t), jnp.array(m))
        tl, cache = T.serve_step(tp, cfg, cache,
                                 torch.from_numpy(toks[:, t:t + 1]), t,
                                 write_mask=torch.from_numpy(m))
        assert tl.shape == (b, 1, cfg.padded_vocab)
        assert _rel(tl, rl) <= tol, (t, _rel(tl, rl))
    assert all(ours is enc for ours, enc in zip(cache["cross_kv"], cross))
    for ours, theirs in zip(cache["kv"], rcache["kv"]):
        theirs = np.asarray(theirs, np.float32)
        assert (np.asarray(ours.float()) == 0).sum() == (theirs == 0).sum()
        assert _rel(ours.float(), theirs) <= tol


def _decode(tp, cfg, batch, b, s):
    cache = T.init_cache(cfg, b, s + 2, device="cpu")
    if cfg.family == "encdec":
        cache = T.encode(tp, cfg, batch["audio_embeds"], cache)
    outs = []
    for t in range(s):
        lg, cache = step_fns.make_serve_step(cfg)(
            tp, cache, batch["tokens"][:, t:t + 1], t)
        outs.append(lg.reshape(b, -1))
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", ARCHS2)
def test_decode_matches_forward(arch, policy):
    """The KV-cache decode reproduces the teacher-forced forward, as
    ``tests/test_decode_consistency.py`` holds the reference.  The VLM's
    decode takes no images, so its forward gets the first tokens' own
    embeddings as ``img_embeds``: the same dense stack."""
    _, cfg = _cfgs(arch, policy)
    _, tp = _params(arch)
    b, s = 2, 10
    batch = _port(_batch(cfg, b, s, 8))
    if cfg.family == "vlm":
        batch["img_embeds"] = tp["embed"][
            batch["tokens"][:, :cfg.n_img_tokens].long()]
    tf, _ = T.forward(tp, cfg, batch)
    dec = _decode(tp, cfg, batch, b, s)
    np.testing.assert_allclose(dec[:, 1:].numpy(), tf[:, 1:].numpy(),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(dec[:, -1].argmax(-1), tf[:, -1].argmax(-1))


def test_write_mask_keeps_masked_rows_and_cross_kv():
    """A masked row keeps its ``kv`` rows bit for bit; ``cross_kv`` is the
    encoded one for every row; the raw (maskless) step overwrites the
    masked row's self-attention cache."""
    _, cfg = _cfgs(ENCDEC, "fp32")
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    audio = torch.randn((2, cfg.enc_seq, cfg.d_model),
                        generator=torch.Generator().manual_seed(1))
    enc = T.encode(tp, cfg, audio, T.init_cache(cfg, 2, 16, device="cpu"))
    cache = enc
    for t in range(3):
        tok = torch.tensor([[5 + t], [0]])
        _, cache = T.serve_step(tp, cfg, cache, tok, t,
                                write_mask=torch.tensor([True, False]))
    kv = cache["kv"]
    assert kv.k[:, 0, :, :3].abs().sum() > 0
    assert not kv.k[:, 1].any() and not kv.v[:, 1].any()
    for ours, encoded in zip(cache["cross_kv"], enc["cross_kv"]):
        assert torch.equal(ours, encoded)
    _, masked = T.serve_step(tp, cfg, cache, torch.tensor([[0], [9]]), 3,
                             write_mask=torch.tensor([False, True]))
    assert torch.equal(masked["kv"].k[:, 0], kv.k[:, 0])
    assert torch.equal(masked["kv"].v[:, 0], kv.v[:, 0])
    assert masked["kv"].k[:, 1, :, 3].abs().sum() > 0
    for ours, encoded in zip(masked["cross_kv"], enc["cross_kv"]):
        assert torch.equal(ours, encoded)
    _, raw = T.serve_step(tp, cfg, cache, torch.tensor([[0], [9]]), 0)
    assert (raw["kv"].k[:, 0, :, 0] - kv.k[:, 0, :, 0]).abs().sum() > 0


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["native_bf16", "kom_int14"])
def test_vlm_engine_greedy_tokens_match_reference_engine(policy):
    """The VLM served as its dense stack (no images, as in the reference).
    kom_int14 (f32 compute): the reference engine's greedy tokens exactly.
    native_bf16: every token the port emits is within TOL_BF16 (of max
    |logit|) of the best logit of the reference's jitted serve_step,
    replayed one slot at a time as the engines feed it (the prompt, its
    last token again, then each emitted token)."""
    ref_cfg, cfg = _cfgs(VLM, policy)
    rp, tp = _params(VLM)
    prompts = [np.random.default_rng(10 + n).integers(
        1, cfg.vocab_size, (n,)).astype(np.int32) for n in (5, 3, 7)]
    max_new = 5
    eng = ServeEngine(cfg, tp, slots=2, max_len=32, device="cpu")
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=max_new))
    got = {u: r.out_tokens for u, r in eng.run().items()}
    assert sorted(got) == [0, 1, 2]
    if policy == "kom_int14":
        ref = RefEngine(ref_cfg, rp, slots=2, max_len=32)
        for uid, p in enumerate(prompts):
            ref.submit(RefRequest(uid=uid, prompt=p,
                                  max_new_tokens=max_new))
        assert {u: r.out_tokens for u, r in ref.run().items()} == got
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


def test_engines_and_launcher_refuse_encdec(capsys):
    """Both packages' ServeEngine refuse an encoder-decoder alike; the
    port's launcher prints the reference's message and exits 2 before it
    builds anything (as ``python -m repro_torch.launch.serve --arch
    whisper-large-v3 --reduced --device cpu`` does)."""
    from repro.launch.serve import main as ref_main
    from repro_torch.launch.serve import main
    ref_cfg, cfg = _cfgs(ENCDEC, "fp32")
    rp, tp = _params(ENCDEC)
    with pytest.raises(NotImplementedError,
                       match="engine serves decoder-only families"):
        RefEngine(ref_cfg, rp)
    with pytest.raises(NotImplementedError,
                       match="engine serves decoder-only families"):
        ServeEngine(cfg, tp, device="cpu")
    assert ref_main(["--arch", ENCDEC]) == 2
    want = capsys.readouterr().out
    assert main(["--arch", ENCDEC, "--reduced", "--device", "cpu"]) == 2
    assert capsys.readouterr().out == want == (
        "engine serves decoder-only families; pick another arch\n")


def test_lm_launcher_serves_the_vlm_on_cpu(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", VLM, "--reduced", "--device", "cpu",
                 "--requests", "2", "--slots", "2", "--max-new", "2",
                 "--policy", "kom_int14", "--param-dtype", "bfloat16"]) == 0
    assert f"{VLM}/kom_int14 on cpu: 2 requests" in capsys.readouterr().out


def test_noncausal_flash_refuses_keys_off_the_block():
    """130 keys do not fill 128-key blocks: a non-causal call raises in
    both packages' wrappers (whisper's 1500 frames at full width alike),
    and 128 keys run."""
    r = np.random.default_rng(9)
    q, k, v = (r.standard_normal((1, 2, 8, 16)).astype(np.float32)
               for _ in range(3))
    k, v = np.tile(k, (1, 1, 17, 1))[:, :, :130], np.tile(
        v, (1, 1, 17, 1))[:, :, :130]
    with pytest.raises(ValueError, match="skv divisible by block_k"):
        ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=False)
    with pytest.raises(ValueError, match="skv divisible by block_k"):
        flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=False)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k[:, :, :128]),
                          torch.from_numpy(v[:, :, :128]), causal=False)
    assert out.shape == q.shape and torch.isfinite(out).all()


def test_engine_donate_quantizes_the_callers_tree_in_place():
    """``ServeEngine(donate=True)`` under kom_int14 quantizes the caller's
    tree in place (the float weights replaced one at a time: internvl2's
    bf16 tree and its QWeights do not fit one card side by side), to the
    same QWeights as the copying pass, and serves the same tokens."""
    from repro_torch.core.substrate import QWeight
    from repro_torch.serving.weight_quant import quantize_params_inline
    _, cfg = _cfgs(VLM, "kom_int14")
    _, tp = _params(VLM)
    _, spent = _params(VLM)
    want = quantize_params_inline(tp)
    prompt = np.arange(3, 9, dtype=np.int32)
    tokens = {}
    for donate, params in ((False, tp), (True, spent)):
        eng = ServeEngine(cfg, params, slots=2, max_len=16, device="cpu",
                          donate=donate)
        eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=4))
        tokens[donate] = eng.run()[0].out_tokens
    assert tokens[True] == tokens[False]
    assert isinstance(spent["layers"]["mlp"]["w_up"], QWeight)
    assert not isinstance(tp["layers"]["mlp"]["w_up"], QWeight)
    for name, w in _flat(want).items():
        got = _flat(spent)[name]
        if isinstance(w, QWeight):
            assert torch.equal(got.values, w.values), name
            assert torch.equal(got.scale, w.scale), name
        else:
            assert torch.equal(got, w), name


@pytest.mark.parametrize("stack", [(3,), (2, 3)])
def test_quantize_weight_one_layer_at_a_time(stack):
    """A stacked weight is quantized one stack entry at a time: the values
    and (..., 1, n) scales of the whole-stack arithmetic, bit for bit."""
    from repro_torch.core.substrate import kom_qmax, quantize_weight
    w = torch.randn(stack + (40, 24), generator=torch.Generator(
        ).manual_seed(len(stack))).to(torch.bfloat16)
    got = quantize_weight(w, stack_axes=len(stack))
    w32 = w.float()
    amax = w32.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12)
    scale = amax / torch.full_like(amax, kom_qmax(7))
    values = torch.clamp(torch.round(w32 / scale), -kom_qmax(7),
                         kom_qmax(7)).to(torch.int16)
    assert got.scale.shape == stack + (1, 24)
    assert torch.equal(got.scale, scale) and torch.equal(got.values, values)
