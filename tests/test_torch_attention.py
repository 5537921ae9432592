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
