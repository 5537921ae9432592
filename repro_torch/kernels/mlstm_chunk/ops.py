"""Public wrapper for the chunkwise mLSTM kernel (pads the sequence)."""
from __future__ import annotations

import torch.nn.functional as F

from .mlstm_chunk import mlstm_chunk_raw


def mlstm_chunk(q, k, v, log_f, i_gate, *, chunk: int = 64):
    """Chunkwise mLSTM; q/k/v (b, h, s, dh), gates (b, h, s) -> f32 y.

    Runs chunk ``c = min(chunk, s)`` and pads the sequence to a multiple
    of it with zeros, as the reference does: padded steps have input gate
    0 (they write nothing into the state) and come after every real step,
    so they change no real output, and are sliced off.
    """
    s = q.shape[2]
    c = min(chunk, s)
    ps = (-s) % c
    if ps:
        q, k, v = (F.pad(t, (0, 0, 0, ps)) for t in (q, k, v))
        log_f, i_gate = (F.pad(t, (0, ps)) for t in (log_f, i_gate))
    out = mlstm_chunk_raw(q, k, v, log_f, i_gate, chunk=c)
    return out[:, :, :s, :]
