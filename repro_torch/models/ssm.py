"""Recurrent sequence mixers: mLSTM and sLSTM (xLSTM) and RG-LRU (Griffin,
the hybrid family's recurrent block) -- the port of ``repro.models.ssm``.

The projections route through the precision policy (``layers.dense``); the
recurrences are elementwise and run in f32.  mLSTM uses the chunkwise
form -- an intra-chunk attention-like block plus a carried (dk x dv) state
and (dk) normalizer -- with the reference's arithmetic: every exponent
clipped to [-60, 0] inside its ``exp``, ``y / max(|n|, 1)``, a sigmoid
input gate and a log-sigmoid forget gate.  sLSTM is a true recurrence, a
Python loop over time.

The chunk loop runs in Python here, as ``lax.scan`` runs it in the
reference; the CUDA kernel of the same function is the op
:func:`repro_torch.kernels.mlstm_chunk.mlstm_chunk`, which no model calls
(as in the reference).

RG-LRU's prefill recurrence ``h_t = a_t h_{t-1} + b_t`` runs as the
reference's ``lax.associative_scan``: the same odd/even recursion (combine
adjacent pairs, recurse on the half, combine the even elements, interleave),
O(log s) tensor ops a layer and no loop over time steps.  Decode folds the
carried ``h`` in step by step, as the reference's ``lax.scan`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .layers import (_randn, causal_conv1d, dense, linear_init, norm_init,
                     rms_norm)


def _clip_exp(x: torch.Tensor) -> torch.Tensor:
    """``exp(clip(x, -60, 0))``: every exponent of the mLSTM."""
    return torch.exp(torch.clamp(x, -60.0, 0.0))


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, chunkwise)
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    s: torch.Tensor     # (b, h, dk, dv) matrix memory
    n: torch.Tensor     # (b, h, dk) normalizer
    conv: torch.Tensor  # (b, kconv-1, d_inner) causal-conv tail


def mlstm_init(gen: torch.Generator, cfg, dtype=torch.float32):
    d = cfg.d_model
    di = d * 2  # up-projection factor 2
    h = cfg.n_heads
    return {
        "w_up": linear_init(gen, d, di, dtype),
        "w_gate": linear_init(gen, d, di, dtype),
        "conv_w": (_randn(gen, (4, di), dtype) * 0.1).to(dtype),
        "wq": linear_init(gen, di, di, dtype),
        "wk": linear_init(gen, di, di, dtype),
        "wv": linear_init(gen, di, di, dtype),
        "w_if": linear_init(gen, d, 2 * h, dtype),
        "out_norm": norm_init(di, "rms", dtype, gen.device),
        "w_down": linear_init(gen, di, d, dtype),
    }


def causal_mask(chunk: int, device) -> torch.Tensor:
    """The intra-chunk mask: token t sees keys s <= t (its own included)."""
    return torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=device))


def state_write_weights(ltot, lcum, i_gate):
    """Each token's weight in the state update:
    ``exp(clip(ltot - lcum_s, -60, 0)) * i_s``."""
    return _clip_exp(ltot - lcum) * i_gate


def _mlstm_chunk_scan(q, k, v, log_f, i_gate, state, n_state, chunk: int):
    """Chunkwise gated linear attention.

    q/k/v: (b, h, s, dh); log_f, i_gate: (b, h, s); state (b, h, dk, dv),
    n_state (b, h, dk).  Returns (y, state', n_state').
    """
    b, h, s, dh = q.shape
    assert s % chunk == 0, (s, chunk)
    causal = causal_mask(chunk, q.device)
    st, nt = state, n_state
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        qt, kt, vt = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        lf, ig = log_f[:, :, sl], i_gate[:, :, sl]
        lcum = torch.cumsum(lf, dim=-1)  # inclusive cumulative log-decay
        ltot = lcum[..., -1:]
        # intra-chunk: score[t,s] = (q_t . k_s) * exp(lcum_t - lcum_s) * i_s
        scores = torch.einsum("bhtd,bhsd->bhts", qt, kt)
        decay = _clip_exp(lcum[..., :, None] - lcum[..., None, :])
        scores = scores * decay * ig[..., None, :] * causal
        y_intra = torch.einsum("bhts,bhsd->bhtd", scores, vt)
        # inter-chunk: carry-in state decayed to position t
        qdec = qt * _clip_exp(lcum)[..., None]
        y_inter = torch.einsum("bhtk,bhkv->bhtv", qdec, st)
        n_inter = torch.einsum("bhtk,bhk->bht", qdec, nt)
        # the intra part of q . n_t is exactly the score row-sum
        y = y_intra + y_inter
        n_tok = torch.sum(scores, dim=-1) + n_inter
        y = y / torch.clamp(torch.abs(n_tok), min=1.0)[..., None]
        wdec = state_write_weights(ltot, lcum, ig)  # (b, h, c)
        ftot = _clip_exp(ltot)
        st = st * ftot[..., None] + torch.einsum(
            "bhck,bhcv->bhkv", kt * wdec[..., None], vt)
        nt = nt * ftot + torch.einsum("bhck,bhc->bhk", kt, wdec)
        ys.append(y)
    return torch.cat(ys, dim=2), st, nt


def mlstm_block(params, x, cfg, state: Optional[MLSTMState] = None,
                chunk: int = 64):
    """x (b, s, d) -> (y, new_state).  ``state`` given: decode (the whole
    input is one chunk).  Prefill runs chunk ``chunk`` when it divides s,
    else one chunk of s (the reference's fallback; the model does not pad
    the way the op does)."""
    b, s, d = x.shape
    di = d * 2
    h = cfg.n_heads
    dh = di // h
    policy = cfg.policy
    f32 = torch.float32
    up = dense(x, params["w_up"], policy=policy)
    gate = dense(x, params["w_gate"], policy=policy)
    cstate = state.conv if state is not None else None
    cx, new_conv = causal_conv1d(up, params["conv_w"], cstate)
    cx = F.silu(cx.to(f32)).to(x.dtype)

    def heads(t):
        return t.reshape(b, s, h, dh).transpose(1, 2)

    q = heads(dense(cx, params["wq"], policy=policy))
    k = heads(dense(cx, params["wk"], policy=policy))
    # jnp divides by the Python scalar rounded to k's dtype (a weak type)
    k = k / torch.full((), dh ** 0.5, dtype=k.dtype, device=k.device)
    v = heads(dense(up, params["wv"], policy=policy))
    gates = dense(x, params["w_if"], policy=policy).to(f32)
    i_gate = torch.sigmoid(gates[..., :h]).transpose(1, 2)  # (b, h, s)
    log_f = F.logsigmoid(gates[..., h:]).transpose(1, 2)
    if state is None:
        s0 = torch.zeros((b, h, dh, dh), dtype=f32, device=x.device)
        n0 = torch.zeros((b, h, dh), dtype=f32, device=x.device)
        ch = chunk if s % chunk == 0 else s
    else:
        s0, n0, ch = state.s, state.n, s
    y, s1, n1 = _mlstm_chunk_scan(q.to(f32), k.to(f32), v.to(f32), log_f,
                                  i_gate, s0, n0, ch)
    y = y.transpose(1, 2).reshape(b, s, di).to(x.dtype)
    y = rms_norm(y, params["out_norm"]["w"])
    y = y * F.silu(gate.to(f32)).to(x.dtype)
    out = dense(y, params["w_down"], policy=policy)
    return out, MLSTMState(s1, n1, new_conv)


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, a true recurrence: a loop over time)
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    h: torch.Tensor  # (b, d)
    c: torch.Tensor  # (b, d)
    n: torch.Tensor  # (b, d), starts at ones


def slstm_init(gen: torch.Generator, cfg, dtype=torch.float32):
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    return {
        "w_in": linear_init(gen, d, 4 * d, dtype),
        # block-diagonal recurrent weights, one (dh x 4dh) block per head
        "r": (_randn(gen, (h, dh, 4 * dh), dtype) / dh ** 0.5).to(dtype),
        "b": torch.zeros((4 * d,), dtype=dtype, device=gen.device),
        "w_down": linear_init(gen, d, d, dtype),
    }


def slstm_state0(b: int, d: int, device) -> SLSTMState:
    """The fresh sLSTM state: h and c zero, the normalizer n ONE."""
    z = torch.zeros((b, d), dtype=torch.float32, device=device)
    return SLSTMState(z, z.clone(), torch.ones_like(z))


def slstm_block(params, x, cfg, state: Optional[SLSTMState] = None):
    """x (b, s, d) -> (y, new_state); a sequential loop over time."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    policy = cfg.policy
    zx = dense(x, params["w_in"], policy=policy) + params["b"]  # (b, s, 4d)
    st = state if state is not None else slstm_state0(b, d, x.device)
    r = params["r"].to(torch.float32)
    ys = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", st.h.reshape(b, h, dh),
                           r).reshape(b, 4 * d)
        g = zx[:, t].to(torch.float32) + rec
        zi, ii, ff, oo = torch.split(g, d, dim=-1)
        z = torch.tanh(zi)
        i = torch.exp(torch.clamp(ii, -10.0, 10.0))
        f = torch.sigmoid(ff)
        o = torch.sigmoid(oo)
        c = f * st.c + i * z
        n = f * st.n + i
        hnew = o * c / torch.clamp(torch.abs(n), min=1.0)
        st = SLSTMState(hnew, c, n)
        ys.append(hnew)
    y = torch.stack(ys, dim=1).to(x.dtype)  # (b, s, d)
    return dense(y, params["w_down"], policy=policy), st


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------

class RGLRUState(NamedTuple):
    h: torch.Tensor     # (b, d_rnn) f32
    conv: torch.Tensor  # (b, kconv-1, d_rnn) causal-conv tail


def rglru_init(gen: torch.Generator, cfg, dtype=torch.float32):
    """The reference's leaves and distributions, drawn from ``gen`` on its
    own device: ``lam`` uniform in [2.5, 5.5) (f32), so that ``a =
    sigmoid(lam)`` lies in (0.9, 0.999)."""
    d, dr = cfg.d_model, cfg.rnn_width
    return {
        "w_x": linear_init(gen, d, dr, dtype),
        "w_y": linear_init(gen, d, dr, dtype),
        "conv_w": (_randn(gen, (4, dr), dtype) * 0.1).to(dtype),
        "w_a": linear_init(gen, dr, dr, dtype),
        "w_i": linear_init(gen, dr, dr, dtype),
        "lam": torch.rand((dr,), generator=gen, dtype=torch.float32,
                          device=gen.device) * 3.0 + 2.5,
        "w_out": linear_init(gen, dr, d, dtype),
    }


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``even[i]`` at 2i and ``odd[i]`` at 2i + 1 along axis 1."""
    shape = list(even.shape)
    shape[1] += odd.shape[1]
    out = even.new_empty(shape)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan over axis 1 of ``(a_l, b_l) . (a_r, b_r) = (a_l a_r,
    a_r b_l + b_r)`` in ``jax.lax.associative_scan``'s order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs, then scan the half
    ra = a[:, 0:-1:2] * a[:, 1::2]
    rb = a[:, 1::2] * b[:, 0:-1:2] + b[:, 1::2]
    oa, ob = _associative_scan(ra, rb)
    # the even elements: the odd prefix before each, then the element
    pa, pb = (oa[:, :-1], ob[:, :-1]) if n % 2 == 0 else (oa, ob)
    ar, br = a[:, 2::2], b[:, 2::2]
    ea = torch.cat([a[:, :1], pa * ar], dim=1)
    eb = torch.cat([b[:, :1], ar * pb + br], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _rglru_coeffs(xg: torch.Tensor, log_a: torch.Tensor):
    """``(a, b)`` of ``h_t = a_t h_{t-1} + b_t``: ``a = exp(log_a)``, ``b =
    sqrt(clip(1 - a^2, 1e-12, 1)) * xg``."""
    a = torch.exp(log_a)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, 1e-12, 1.0)) * xg


def _rglru_scan(xg: torch.Tensor, log_a: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, by associative scan over
    the sequence axis 1."""
    return _associative_scan(*_rglru_coeffs(xg, log_a))[1]


def rglru_block(params, x, cfg, state: Optional[RGLRUState] = None):
    """Griffin recurrent block: x (b, s, d) -> (y, new_state).  A GeLU
    branch and a conv branch; the conv branch's sigmoid gates ``r``, ``i``
    drive the RG-LRU core in f32.  ``state`` None: prefill from h = 0 (the
    associative scan); else decode, folding ``state.h`` in step by step."""
    policy = cfg.policy
    f32 = torch.float32
    xb = dense(x, params["w_x"], policy=policy)  # (b, s, dr)
    yb = dense(x, params["w_y"], policy=policy)
    # jax.nn.gelu defaults to the tanh approximation
    yb = F.gelu(yb.to(f32), approximate="tanh").to(x.dtype)
    cstate = state.conv if state is not None else None
    xc, new_conv = causal_conv1d(xb, params["conv_w"], cstate)
    r = torch.sigmoid(dense(xc, params["w_a"], policy=policy).to(f32))
    i = torch.sigmoid(dense(xc, params["w_i"], policy=policy).to(f32))
    lam = params["lam"]
    # jax.nn.softplus is logaddexp(x, 0); F.softplus turns linear past its
    # threshold
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = (-8.0 * softplus) * r  # (b, s, dr)
    gated = i * xc.to(f32)
    if state is None:
        h = _rglru_scan(gated, log_a)
        h_last = h[:, -1]
    else:
        a, bterm = _rglru_coeffs(gated, log_a)
        h_last, hs = state.h, []
        for t in range(x.shape[1]):
            h_last = a[:, t] * h_last + bterm[:, t]
            hs.append(h_last)
        h = torch.stack(hs, dim=1)
    out = h.to(x.dtype) * yb
    y = dense(out, params["w_out"], policy=policy)
    return y, RGLRUState(h_last, new_conv)
