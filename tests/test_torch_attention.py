"""The port's attention kernels' plain versions against the JAX reference.

``flash_attention`` and ``flash_decode`` on CPU tensors run their plain
PyTorch versions (the TPU kernels' block schedules); here they are held
against the reference's Pallas kernels in interpret mode and its jnp
oracles, at the shapes of ``tests/test_kernels.py`` and
``tests/test_flash_decode.py``.  Tolerances are the reference's own
kernel-vs-oracle ones: 2e-5 for f32 (outputs are O(1); the sums run in
another order), 2e-2 for bf16 outputs (one bf16 ulp).  Every f32 check has
a mutant control that must MISS 2e-5: the plain version with causal ``>``
for ``>=`` (attention) or ``<`` for ``<=`` (decode).
"""
import contextlib
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as ref_attention  # noqa: E402
from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_decode import decode_attention_ref as ref_decode_oracle  # noqa: E402
from repro.kernels.flash_decode import flash_decode as ref_decode  # noqa: E402
from repro_torch.analysis.roofline import (attention_roofline,  # noqa: E402
                                           decode_attention_roofline)
from repro_torch.kernels.flash_attention import (attention_ref,  # noqa: E402
                                                 flash_attention)
from repro_torch.kernels.flash_decode import (decode_attention_ref,  # noqa: E402
                                              flash_decode)
from repro_torch.kernels.flash_decode.flash_decode import (  # noqa: E402
    CHUNK, NEG_INF, flash_decode_plain, flash_decode_splits)

TOL_F32 = 2e-5
TOL_BF16 = 2e-2
FA_MOD = "repro_torch.kernels.flash_attention.flash_attention"
FD_MOD = "repro_torch.kernels.flash_decode.flash_decode"

rng = np.random.default_rng(0)


@contextlib.contextmanager
def mutated(module: str, name: str, make):
    """``module.name`` replaced by ``make(original)`` inside the block."""
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def strict_causal(orig):
    def live(q_pos, k_pos, *, causal, window):
        m = orig(q_pos, k_pos, causal=causal, window=window)
        return m & (q_pos[:, None] != k_pos[None, :]) if causal else m
    return live


def before_pos(orig):
    return lambda k_pos, pos: k_pos < pos


def _arrays(*shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _maxdiff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (2, 4, 4, 64, 64, 32),
    (1, 8, 2, 64, 64, 32),     # GQA
    (1, 4, 1, 96, 96, 16),     # MQA, non-block-multiple
    (1, 4, 4, 1, 128, 32),     # decode shape
])
def test_flash_attention_plain_matches_reference_causal(b, hq, hkv, sq, skv,
                                                        d):
    q, k, v = _arrays((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))
    off = skv - sq
    kw = dict(causal=True, q_offset=off, block_q=32, block_k=32)
    want = np.asarray(ref_flash(jnp.array(q), jnp.array(k), jnp.array(v),
                                **kw))
    oracle = np.asarray(ref_attention(jnp.array(q), jnp.array(k),
                                      jnp.array(v), causal=True,
                                      q_offset=off))
    run = lambda: flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    got = run()
    assert _maxdiff(got, want) <= TOL_F32
    assert _maxdiff(got, oracle) <= TOL_F32
    assert _maxdiff(attention_ref(_t(q), _t(k), _t(v), causal=True,
                                  q_offset=off).numpy(), oracle) <= TOL_F32
    with mutated(FA_MOD, "live_mask", strict_causal):
        assert _maxdiff(run(), want) > TOL_F32


@pytest.mark.parametrize("window", [8, 16, 64])
def test_flash_attention_plain_matches_reference_window(window):
    q, k, v = _arrays((1, 2, 64, 16), (1, 2, 64, 16), (1, 2, 64, 16))
    kw = dict(causal=True, window=window, block_q=16, block_k=16)
    want = np.asarray(ref_flash(jnp.array(q), jnp.array(k), jnp.array(v),
                                **kw))
    run = lambda: flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    assert _maxdiff(run(), want) <= TOL_F32
    with mutated(FA_MOD, "live_mask", strict_causal):
        assert _maxdiff(run(), want) > TOL_F32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_reference_dtypes(dtype):
    q, k, v = _arrays((1, 2, 32, 16), (1, 2, 32, 16), (1, 2, 32, 16))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(ref_flash(jnp.array(q, jd), jnp.array(k, jd),
                                jnp.array(v, jd), block_q=16, block_k=16),
                      np.float32)
    run = lambda: flash_attention(_t(q, td), _t(k, td), _t(v, td),
                                  block_q=16, block_k=16).float().numpy()
    got = run()
    assert got.dtype == np.float32
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    assert _maxdiff(got, want) <= tol
    if dtype == "float32":
        with mutated(FA_MOD, "live_mask", strict_causal):
            assert _maxdiff(run(), want) > TOL_F32


def test_flash_attention_wholly_masked_leading_blocks_match_reference():
    """A window whose leading KV blocks are wholly masked for some rows,
    and rows with NO live key at all (q_offset past the cache): the plain
    version keeps the reference's -1e30 arithmetic, so both agree."""
    q, k, v = _arrays((1, 2, 64, 16), (1, 2, 64, 16), (1, 2, 64, 16))
    for kw in (dict(causal=True, window=8, q_offset=0),
               dict(causal=True, window=4, q_offset=200)):
        want = np.asarray(ref_flash(jnp.array(q), jnp.array(k), jnp.array(v),
                                    block_q=16, block_k=16, **kw))
        got = flash_attention(_t(q), _t(k), _t(v), block_q=16, block_k=16,
                              **kw).numpy()
        assert _maxdiff(got, want) <= TOL_F32


def test_flash_attention_noncausal_padding_raises_like_reference():
    q, k, v = _arrays((1, 2, 8, 16), (1, 2, 40, 16), (1, 2, 40, 16))
    with pytest.raises(ValueError, match="non-causal"):
        ref_flash(jnp.array(q), jnp.array(k), jnp.array(v), causal=False,
                  block_k=32)
    with pytest.raises(ValueError, match="non-causal"):
        flash_attention(_t(q), _t(k), _t(v), causal=False, block_k=32)
    q, k, v = _arrays((1, 2, 8, 16), (1, 2, 64, 16), (1, 2, 64, 16))
    want = np.asarray(ref_attention(jnp.array(q), jnp.array(k), jnp.array(v),
                                    causal=False))
    got = flash_attention(_t(q), _t(k), _t(v), causal=False,
                          block_k=32).numpy()
    assert _maxdiff(got, want) <= TOL_F32


@pytest.mark.parametrize("b,hq,hkv,S,dh,pos,bk", [
    (2, 4, 4, 256, 32, 100, 64),
    (1, 8, 2, 512, 64, 511, 128),   # GQA, full cache
    (1, 4, 1, 300, 32, 7, 64),      # MQA, non-multiple cache, short valid
    (2, 16, 16, 128, 128, 127, 128),
])
def test_flash_decode_plain_matches_reference(b, hq, hkv, S, dh, pos, bk):
    q, k, v = _arrays((b, hq, 1, dh), (b, hkv, S, dh), (b, hkv, S, dh))
    want = np.asarray(ref_decode(jnp.array(q), jnp.array(k), jnp.array(v),
                                 jnp.int32(pos), block_k=bk))
    oracle = np.asarray(ref_decode_oracle(jnp.array(q), jnp.array(k),
                                          jnp.array(v), pos))
    run = lambda: flash_decode(_t(q), _t(k), _t(v), pos, block_k=bk).numpy()
    got = run()
    assert _maxdiff(got, want) <= TOL_F32
    assert _maxdiff(got, oracle) <= TOL_F32
    assert _maxdiff(decode_attention_ref(_t(q), _t(k), _t(v), pos).numpy(),
                    oracle) <= TOL_F32
    with mutated(FD_MOD, "valid_keys", before_pos):
        assert _maxdiff(run(), want) > TOL_F32


@pytest.mark.parametrize("dtype,tol", [("float32", TOL_F32),
                                       ("bfloat16", TOL_BF16)])
def test_flash_decode_plain_matches_reference_dtypes(dtype, tol):
    q, k, v = _arrays((1, 4, 1, 32), (1, 4, 128, 32), (1, 4, 128, 32))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(ref_decode(jnp.array(q, jd), jnp.array(k, jd),
                                 jnp.array(v, jd), jnp.int32(64)),
                      np.float32)
    run = lambda: flash_decode(_t(q, td), _t(k, td), _t(v, td),
                               64).float().numpy()
    assert _maxdiff(run(), want) <= tol
    if dtype == "float32":
        with mutated(FD_MOD, "valid_keys", before_pos):
            assert _maxdiff(run(), want) > TOL_F32


def test_flash_decode_masks_padded_cache():
    """Keys past pos (incl. the wrapper's padding) must not contribute.

    A property of the port alone, checked against the reference's jnp
    oracle rather than its interpret-mode Pallas kernel."""
    q, k, v = _arrays((1, 2, 1, 16), (1, 2, 100, 16), (1, 2, 100, 16))
    out_a = flash_decode(_t(q), _t(k), _t(v), 10, block_k=64)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 50:] = 99.0
    v2[:, :, 50:] = -99.0
    out_b = flash_decode(_t(q), _t(k2), _t(v2), 10, block_k=64)
    assert torch.equal(out_a, out_b)
    oracle = np.asarray(ref_decode_oracle(jnp.array(q), jnp.array(k),
                                          jnp.array(v), 10))
    assert _maxdiff(out_a.numpy(), oracle) <= TOL_F32


#: The decode kernel's block (``csrc/flash_decode.cu``): 4 warps, each
#: owning 16 keys of a 64-key chunk; a lane group of dh / (16 bytes) lanes
#: shares a key and keeps its own online-softmax state.
DECODE_WARPS = 4


def decode_split_emulation(q, k, v, pos, *, sms=132):
    """The decode kernel's partials and combines in f32, in its order: per
    split of :func:`flash_decode_splits`, each lane group's online softmax
    over its keys of each chunk (up to 4 keys per update; keys at or past
    the split's live end score -inf, every key -1e30 when pos < 0), the
    block's groups combined in order, then the splits."""
    b, hq, _, dh = q.shape
    hkv, S = k.shape[1], k.shape[2]
    g = hq // hkv
    lanes = dh // (16 // q.element_size())
    kp = 32 // lanes
    nk = CHUNK // DECODE_WARPS // kp
    nb = min(nk, 4)
    split, nsplit = flash_decode_splits(S, b, hkv, sms=sms)
    grp = torch.arange(DECODE_WARPS * kp)
    offs = ((grp // kp)[:, None] * (CHUNK // DECODE_WARPS)
            + torch.arange(nk)[None, :] * kp + (grp % kp)[:, None])
    denom = torch.tensor(dh ** 0.5, dtype=torch.float32)
    q32 = q.float().reshape(b, hkv, g, dh)
    k32, v32 = k.float(), v.float()
    parts = []
    for sp in range(nsplit):
        ks0, ks1 = sp * split, min(sp * split + split, S)
        kend = min(pos + 1, ks1) if pos >= 0 else ks1
        ng = len(grp)
        m = torch.full((b, hkv, g, ng), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, ng, dh))
        if pos >= 0 and ks0 > pos:
            parts.append((m[..., 0], l[..., 0], acc[..., 0, :]))
            continue
        for kc0 in range(ks0, kend, CHUNK):
            for i0 in range(0, nk, nb):
                idx = kc0 + offs[:, i0:i0 + nb]
                live = idx < kend
                kk = k32[:, :, idx.clamp(max=S - 1)]
                vv = v32[:, :, idx.clamp(max=S - 1)] * live[..., None]
                s = torch.einsum("bhgd,bhxnd->bhgxn", q32, kk) / denom
                s = torch.where(live, s if pos >= 0 else NEG_INF,
                                -torch.inf)
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhgxn,bhxnd->bhgxd", p, vv)
                m = m_new
        mx = m.amax(dim=-1)
        w = torch.exp(m - mx[..., None])
        parts.append((mx, (l * w).sum(dim=-1),
                      (acc * w[..., None]).sum(dim=-2)))
    pm = torch.stack([p[0] for p in parts], dim=-1)
    pl = torch.stack([p[1] for p in parts], dim=-1)
    pacc = torch.stack([p[2] for p in parts], dim=-2)
    e = torch.exp(pm - pm.amax(dim=-1, keepdim=True))
    lsum = (pl * e).sum(dim=-1)
    out = (pacc * e[..., None]).sum(dim=-2) / torch.where(
        lsum == 0, 1.0, lsum)[..., None]
    return out.reshape(b, hq, 1, dh).to(q.dtype)


DECODE_SPLIT_CASES = [  # b, hq, hkv, S, pos
    (2, 2, 2, 700, -1), (2, 2, 2, 700, 0), (2, 2, 2, 700, 64),
    (2, 2, 2, 700, 699), (2, 8, 2, 700, -1), (2, 8, 2, 700, 0),
    (2, 8, 2, 700, 64), (2, 8, 2, 700, 699),
    (8, 32, 8, 4096, 1663),    # the serving shape: 832-key splits
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,S,pos", DECODE_SPLIT_CASES)
def test_decode_split_order_matches_plain(b, hq, hkv, S, pos, dtype):
    """The kernel's split-K order (emulated above) against the plain
    version and, where pos >= 0, the reference's jnp oracle: S 700 is a
    multiple of no split (64-key splits here: 11), g 1 and 4, pos -1 (every
    key masked), 0, 64 (the first key of split 1) and S - 1; at the serving
    shape pos ends split 1 of five 832-key splits."""
    td = getattr(torch, dtype)
    q, k, v = (_t(a, td) for a in _arrays((b, hq, 1, 64), (b, hkv, S, 64),
                                           (b, hkv, S, 64)))
    split = flash_decode_splits(S, b, hkv)[0]
    assert S % split and (pos != 64 or split == 64)
    got = decode_split_emulation(q, k, v, pos)
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    assert _maxdiff(got.float(), flash_decode_plain(
        q, k, v, pos, block_k=S).float()) <= tol
    if pos >= 0 and dtype == "float32":
        oracle = ref_decode_oracle(*(jnp.array(t.numpy()) for t in (q, k, v)),
                                   pos)
        assert _maxdiff(got.numpy(), oracle) <= TOL_F32


def test_decode_splits_cover_the_card():
    """Every grid gets two blocks per SM or more; splits are whole chunks
    and cover S with the last one short."""
    for S in (64, 300, 700, 4000, 4096, 32768):
        for b, hkv in ((1, 1), (2, 2), (8, 8), (64, 8)):
            split, n = flash_decode_splits(S, b, hkv)
            assert split % CHUNK == 0 and (n - 1) * split < S <= n * split
            assert b * hkv * n >= 264 or split == CHUNK
    assert flash_decode_splits(4096, 8, 8) == (832, 5)


def tc_emulation(q, k, v, *, causal=True, window=None, q_offset=0,
                 block_k=64, p_limbs=2):
    """The bf16 tensor-core kernel's arithmetic in plain PyTorch, f32 out
    (before the cast to bf16): scores from bf16 q . k products (exact in
    f32) summed in f32, the online softmax in f32, and P split into
    ``p_limbs`` bf16 limbs (hi = bf16(p), lo = bf16(p - hi)) before the
    products with the bf16 values, each summed in f32."""
    from repro_torch.kernels.flash_attention.flash_attention import live_mask
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    pad = (-skv) % block_k
    k32, v32 = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
                for t in (k, v))
    q32 = q.float().reshape(b, hkv, hq // hkv, sq, d)
    scale = float(np.float32(1.0 / d ** 0.5))
    q_pos = torch.arange(sq) + q_offset
    m = torch.full((b, hkv, hq // hkv, sq, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, hq // hkv, sq, d))
    for k0 in range(0, skv + pad, block_k):
        kb, vb = (t[:, :, None, k0:k0 + block_k] for t in (k32, v32))
        s = torch.matmul(q32, kb.transpose(-1, -2)) * scale
        k_pos = torch.arange(k0, k0 + block_k)
        s = torch.where(live_mask(q_pos, k_pos, causal=causal,
                                  window=window), s, -1e30)
        s = torch.where(k_pos < skv, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = torch.matmul(hi, vb)
        if p_limbs == 2:
            pv = pv + torch.matmul((p - hi).to(torch.bfloat16).float(), vb)
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.where(l == 0.0, 1.0, l)).reshape(b, hq, sq, d)


TC_CASES = [  # b, hq, hkv, sq, skv, d, q_offset, window
    (2, 4, 4, 64, 64, 32, 0, None),
    (1, 8, 2, 64, 64, 32, 0, None),       # GQA
    (1, 4, 1, 96, 96, 16, 0, None),       # MQA, skv not a block multiple
    (1, 4, 4, 1, 128, 32, 127, None),     # a decode row
    (1, 2, 2, 64, 64, 16, 0, 8),          # window
    (1, 2, 2, 64, 64, 16, 0, 64),
    (1, 2, 2, 48, 192, 64, 144, 80),      # q_offset + window
    (1, 2, 1, 40, 40, 128, 0, None),      # dh 128
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,off,window", TC_CASES)
def test_tensor_core_arithmetic_matches_plain_and_reference(b, hq, hkv, sq,
                                                            skv, d, off,
                                                            window):
    """The bf16 kernel's arithmetic (bf16 products summed in f32, P in two
    bf16 limbs) at bf16 inputs: within TOL_BF16 of the plain version and of
    the reference's Pallas kernel (interpret mode) on the same inputs."""
    q, k, v = _arrays((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))
    bf = torch.bfloat16
    tq, tk, tv = _t(q, bf), _t(k, bf), _t(v, bf)
    kw = dict(causal=True, window=window, q_offset=off)
    got = tc_emulation(tq, tk, tv, **kw).to(bf).float().numpy()
    plain = flash_attention(tq, tk, tv, block_k=32, **kw).float().numpy()
    want = np.asarray(ref_flash(*(jnp.array(a, jnp.bfloat16)
                                  for a in (q, k, v)),
                                block_q=16, block_k=16, **kw), np.float32)
    assert _maxdiff(got, plain) <= TOL_BF16
    assert _maxdiff(got, want) <= TOL_BF16


def test_two_limb_p_is_ten_times_closer_than_one_limb():
    """Why the kernel issues P_hi V + P_lo V: against the f32 plain version
    on the same (bf16-valued) inputs, before any output cast, the two-limb
    P lands at least 10x closer than a single bf16 P."""
    q, k, v = _arrays((1, 4, 128, 64), (1, 4, 256, 64), (1, 4, 256, 64))
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    kw = dict(causal=True, q_offset=128)
    exact = flash_attention(tq.float(), tk.float(), tv.float(), **kw)
    two = float((tc_emulation(tq, tk, tv, **kw) - exact).abs().max())
    one = float((tc_emulation(tq, tk, tv, p_limbs=1, **kw)
                 - exact).abs().max())
    assert 10 * two <= one, (two, one)


def test_attention_rooflines():
    """The bounds chip_smoke.py reports: causal work is the live share of
    the pairs; decode reads the valid K/V once."""
    r = attention_roofline(b=1, hq=1, hkv=1, sq=4, skv=4, dh=8)
    assert r["live_share"] == 10 / 16
    assert r["flops"] == 4 * 4 * 4 * 8 * 10 / 16
    assert r["bytes"] == 4 * 8 * (2 * 4 + 2 * 4)
    w = attention_roofline(b=1, hq=1, hkv=1, sq=4, skv=4, dh=8, window=2)
    assert w["live_share"] == 7 / 16
    o = attention_roofline(b=1, hq=1, hkv=1, sq=2, skv=4, dh=8, q_offset=2)
    assert o["live_share"] == 7 / 8
    d = decode_attention_roofline(b=2, hq=4, hkv=2, S=100, dh=8, pos=9)
    assert d["bytes"] == 4 * 8 * (2 * 2 * 2 * 10 + 2 * 2 * 4)
    assert d["roofline_s"] == max(d["compute_s"], d["memory_s"])
    assert r["kind"] == d["kind"] == "fp32"
    assert r["compute_s"] == r["flops"] / 67e12


def test_attention_rooflines_price_bf16_inputs_at_the_bf16_peak():
    """The bound reads the work, not the implementation: bf16 inputs at the
    bf16 tensor-core peak, with half the bytes.  At one granite-3-2b prefill
    layer that is 68.75 GFLOP of live work, 0.0695 ms (f32: 1.026 ms)."""
    kw = dict(b=4, hq=32, hkv=8, sq=2048, skv=2048, dh=64)
    r16 = attention_roofline(**kw, itemsize=2)
    r32 = attention_roofline(**kw)
    assert r16["kind"] == "bf16" and r16["flops"] == r32["flops"]
    assert r16["bytes"] == r32["bytes"] / 2
    assert r16["compute_s"] == r16["flops"] / 989e12
    assert round(r16["flops"] / 1e9, 2) == 68.75
    assert round(1e3 * r16["roofline_s"], 4) == 0.0695
    assert round(1e3 * r32["roofline_s"], 3) == 1.026
    d = decode_attention_roofline(b=8, hq=32, hkv=8, S=4096, dh=64,
                                  pos=4095, itemsize=2)
    assert d["kind"] == "bf16" and d["compute_s"] == d["flops"] / 989e12
    assert d["roofline_s"] == d["memory_s"]
