"""The three-pass TF32 arithmetic of the f32 flash-attention kernel and the
chunkwise-mLSTM kernels (``repro_torch/csrc/tf32x3.cuh``), emulated on the
CPU and held against the plain versions and the reference's Pallas kernels
(interpret mode).

The card splits each f32 operand x into ``big = tf32(x)`` and ``small =
tf32(x - big)``, ``tf32`` being ``cvt.rna.tf32.f32`` (round to nearest,
ties away from zero, the low 13 bits cleared; emulated by
``repro_torch.analysis.tf32_probe``, which also holds the card's own split
against it), and forms a product as
``a_s b_b + a_b b_s + a_b b_b`` on ``mma.sync`` m16n8k8.  Here an MMA's
8-deep step is modelled as the exact sum of its tf32 products rounded once
to f32 (an f64 sum of 24 such products is exact to ~2^-50), folded into
f32 partials as the kernels fold them.  The tolerances are the port's own:
``TOL_F32`` (2e-5, absolute, O(1) outputs) for attention, ``TOL_OP`` (2e-5
of max |reference|) for the mLSTM.  One TF32 pass (``a_b b_b`` alone) is
~2^-11 of a product off and must miss them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.kernels.mlstm_chunk import mlstm_chunk as ref_mlstm_chunk  # noqa: E402
from repro_torch.analysis.tf32_probe import split, tf32  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    NEG_INF, live_mask)
from repro_torch.models import ssm  # noqa: E402

TOL_F32 = 2e-5
TOL_OP = 2e-5
F = torch.nn.functional


def step(a, b, passes=3):
    """One 8-deep MMA step from zero: a (..., m, 8) @ b (..., 8, n), the
    exact sum of the tf32 products rounded once to f32."""
    (ab, as_), (bb, bs) = split(a), split(b)
    d = ab.double() @ bb.double()
    if passes == 3:
        d = d + as_.double() @ bb.double() + ab.double() @ bs.double()
    return d.float()


def mm(a, b, *, passes=3, nest=None):
    """a (..., m, K) @ b (..., K, n) as the kernels form it: 8-deep steps,
    each folded with an f32 add into a partial of ``nest`` steps (None: all
    of them), the partials added to the total in order."""
    pad = (-a.shape[-1]) % 8
    if pad:
        a, b = F.pad(a, (0, pad)), F.pad(b, (0, 0, 0, pad))
    steps = a.shape[-1] // 8
    nest = nest or steps
    total = None
    for g0 in range(0, steps, nest):
        part = None
        for s in range(g0, min(g0 + nest, steps)):
            d = step(a[..., 8 * s:8 * s + 8], b[..., 8 * s:8 * s + 8, :],
                     passes)
            part = d if part is None else part + d
        total = part if total is None else total + part
    return total


def _bits(vals):
    return torch.tensor(np.array(vals, np.uint32).view(np.int32)).view(
        torch.float32)


# -- the split ---------------------------------------------------------------

@pytest.mark.parametrize("x,want", [
    (0x3F800000, 0x3F800000),   # 1.0
    (0x3F801000, 0x3F802000),   # 1 + 2^-11: a tie, away from zero (RNE: 1)
    (0xBF801000, 0xBF802000),   # the same below zero
    (0x3F800FFF, 0x3F800000),   # just under the tie: down
    (0x3F801001, 0x3F802000),   # just over: up
    (0x3F7FF000, 0x3F800000),   # a tie that carries into the exponent
    (0x00001000, 0x00002000),   # a subnormal tie
    (0x80000FFF, 0x80000000),   # a subnormal that rounds to -0
    (0x00000000, 0x00000000),
    (0x80000000, 0x80000000),
    (0xC2F6E979, 0xC2F6E000),   # -123.456
])
def test_tf32_rounds_to_nearest_ties_away(x, want):
    got = tf32(_bits([x])).view(torch.int32).numpy().view(np.uint32)[0]
    assert got == want, hex(got)


def test_split_is_exact_to_two_to_the_minus_22():
    r = np.random.default_rng(0)
    x = torch.from_numpy((r.standard_normal(20000)
                          * np.exp2(r.integers(-100, 100, 20000)))
                         .astype(np.float32))
    big, small = split(x)
    for part in (big, small):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    x64 = x.double()
    assert torch.equal((x - big).double(), x64 - big.double())
    err = (x64 - big.double() - small.double()).abs()
    assert (err <= 2.0 ** -22 * x64.abs()).all()
    one = (x64 - big.double()).abs()
    assert (one <= 2.0 ** -11 * x64.abs()).all()
    assert (one > 2.0 ** -16 * x64.abs()).float().mean() > 0.9


# -- flash attention ----------------------------------------------------------

def tf32x3_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                     passes=3):
    """The f32 kernel's arithmetic: KV tiles of 64 keys (32 at dh 128, 16
    at dh 256); S from 8-deep steps over dh folded in f32; the online
    softmax in f32; acc = acc * alpha, then each 8-key step of P V added to
    it.  Skipped tiles change nothing (flash_attention.cu), so every tile
    is walked."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    bk = {128: 32, 256: 16}.get(d, 64)
    pad = (-skv) % bk
    kp, vp = (F.pad(t.float(), (0, 0, 0, pad)) for t in (k, v))
    q32 = q.float().reshape(b, hkv, g, sq, d)
    scale = float(np.float32(1.0 / d ** 0.5))
    q_pos = torch.arange(sq) + q_offset
    m = torch.full((b, hkv, g, sq, 1), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, d))
    for k0 in range(0, skv + pad, bk):
        kb, vb = (t[:, :, None, k0:k0 + bk] for t in (kp, vp))
        s = mm(q32, kb.transpose(-1, -2), passes=passes) * scale
        k_pos = torch.arange(k0, k0 + bk)
        s = torch.where(live_mask(q_pos, k_pos, causal=causal,
                                  window=window), s, NEG_INF)
        s = torch.where(k_pos < skv, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha
        for j in range(0, bk, 8):
            acc = acc + step(p[..., j:j + 8], vb[..., j:j + 8, :], passes)
        m = m_new
    return (acc / torch.where(l == 0.0, 1.0, l)).reshape(b, hq, sq, d)


def _maxdiff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,off,window", [
    (1, 4, 2, 96, 96, 64, 0, None),      # GQA, a ragged last tile
    (1, 2, 1, 48, 192, 32, 144, 80),     # q_offset + window
    (1, 2, 2, 40, 40, 128, 0, None),     # dh 128: 32-key tiles
    (1, 2, 1, 40, 72, 256, 32, 24),      # dh 256: 16-key tiles, window
])
def test_three_pass_attention_matches_plain_and_reference(b, hq, hkv, sq, skv,
                                                          d, off, window):
    r = np.random.default_rng(sq + skv + d)
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    kw = dict(causal=True, window=window, q_offset=off)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tf32x3_attention(tq, tk, tv, **kw)
    plain = flash_attention(tq, tk, tv, **kw)
    want = np.asarray(ref_flash(*(jnp.array(a) for a in (q, k, v)),
                                block_q=16, block_k=16, **kw))
    assert _maxdiff(got, plain) <= TOL_F32
    assert _maxdiff(got, want) <= TOL_F32


def test_one_tf32_pass_misses_the_attention_tolerance():
    """Why the kernel issues three passes: at a granite head (dh 64) one
    tf32 pass lands far past TOL_F32, three land well inside it."""
    r = np.random.default_rng(1)
    tq, tk, tv = (torch.from_numpy(r.standard_normal((1, 2, 128, 64))
                                   .astype(np.float32)) for _ in range(3))
    plain = flash_attention(tq, tk, tv)
    three = _maxdiff(tf32x3_attention(tq, tk, tv), plain)
    one = _maxdiff(tf32x3_attention(tq, tk, tv, passes=1), plain)
    assert 10 * three <= TOL_F32 < one, (three, one)


# -- the chunkwise mLSTM -------------------------------------------------------

def _clip_exp(x):
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def tf32x3_mlstm(q, k, v, lf, ig, *, chunk, passes=3, mutant=None):
    """The two kernels' schedule: the state walk writes each chunk's start
    state (kw^T v over the chunk's tokens, one nested partial), then every
    chunk's outputs from its start state -- the scores and y_inter over dh
    in 32-column partials, P v over the tokens.  ``mutant``: the causal
    mask without its diagonal (``strict_causal``) or the state written
    without the input gate (``no_input_gate``)."""
    s = q.shape[2]
    c = min(chunk, s)
    ps = (-s) % c
    if ps:
        q, k, v = (F.pad(t, (0, 0, 0, ps)) for t in (q, k, v))
        lf, ig = (F.pad(t, (0, ps)) for t in (lf, ig))
    b, h, sp, dh = q.shape
    nc = sp // c
    st = torch.zeros((b, h, dh, dh))
    n = torch.zeros((b, h, dh))
    starts = []
    for i in range(nc):   # (a) the state walk
        starts.append((st, n))
        sl = slice(i * c, (i + 1) * c)
        lcum = torch.cumsum(lf[:, :, sl], dim=-1)
        ltot = lcum[..., -1:]
        w = _clip_exp(ltot - lcum)
        if mutant != "no_input_gate":
            w = w * ig[:, :, sl]
        kt = k[:, :, sl]
        part = mm((kt * w[..., None]).transpose(-1, -2), v[:, :, sl],
                  passes=passes)
        ftot = _clip_exp(ltot)
        st = st * ftot[..., None] + part
        n = n * ftot + torch.einsum("bhck,bhc->bhk", kt, w)
    diag = -1 if mutant == "strict_causal" else 0
    causal = torch.ones((c, c), dtype=torch.bool).tril(diagonal=diag)
    ys = []
    for i in range(nc):   # (b) the outputs
        sl = slice(i * c, (i + 1) * c)
        qt, kt, vt = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        lcum = torch.cumsum(lf[:, :, sl], dim=-1)
        scores = mm(qt, kt.transpose(-1, -2), passes=passes, nest=4)
        decay = _clip_exp(lcum[..., :, None] - lcum[..., None, :])
        p = torch.where(causal, scores * decay * ig[:, :, None, sl], 0.0)
        y = mm(p, vt, passes=passes)
        ntok = p.sum(dim=-1)
        if i:
            qdec = qt * _clip_exp(lcum)[..., None]
            y = y + mm(qdec, starts[i][0], passes=passes, nest=4)
            ntok = ntok + torch.einsum("bhtk,bhk->bht", qdec, starts[i][1])
        ys.append(y / torch.clamp(ntok.abs(), min=1.0)[..., None])
    return torch.cat(ys, dim=2)[:, :, :s]


def _mlstm_inputs(b, h, s, dh, seed=0):
    """tests/test_mlstm_kernel.py's distributions, from a seed."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, h, s, dh)).astype(np.float32)
    k = (r.standard_normal((b, h, s, dh)) * 0.3).astype(np.float32)
    v = r.standard_normal((b, h, s, dh)).astype(np.float32)
    lf = np.log(r.uniform(0.7, 0.99, (b, h, s))).astype(np.float32)
    ig = r.uniform(0.1, 0.9, (b, h, s)).astype(np.float32)
    return q, k, v, lf, ig


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b,h,s,dh,c", [
    (2, 2, 64, 16, 16),
    (1, 4, 128, 32, 64),
    (1, 2, 100, 16, 32),   # padded (s % chunk != 0)
    (2, 1, 32, 64, 32),
])
def test_two_kernel_mlstm_matches_reference(b, h, s, dh, c):
    """At tests/test_mlstm_kernel.py's shapes, within TOL_OP of the
    reference's Pallas kernel (interpret mode); where there is more than one
    chunk, both mutants miss it."""
    arrays = _mlstm_inputs(b, h, s, dh)
    want = np.asarray(ref_mlstm_chunk(*(jnp.array(a) for a in arrays),
                                      chunk=c))
    t = [torch.from_numpy(a) for a in arrays]
    assert _rel(tf32x3_mlstm(*t, chunk=c), want) <= TOL_OP
    if s > c:
        for mutant in ("strict_causal", "no_input_gate"):
            assert _rel(tf32x3_mlstm(*t, chunk=c, mutant=mutant),
                        want) > TOL_OP, mutant


def test_two_kernel_mlstm_matches_the_model_chunk_loop():
    """Against the plain version (the model's chunk loop) at 7 chunks of 64,
    dh 96 -- a ragged sub-tile and dv tile -- within TOL_OP; one tf32 pass
    misses it."""
    t = [torch.from_numpy(a) for a in _mlstm_inputs(1, 2, 448, 96, seed=3)]
    z = torch.zeros
    plain, _, _ = ssm._mlstm_chunk_scan(*t, z((1, 2, 96, 96)), z((1, 2, 96)),
                                        64)
    assert _rel(tf32x3_mlstm(*t, chunk=64), plain) <= TOL_OP
    assert _rel(tf32x3_mlstm(*t, chunk=64, passes=1), plain) > TOL_OP
