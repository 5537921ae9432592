"""The sequential oracle: the model's chunkwise mLSTM at chunk 1."""
from __future__ import annotations

import torch

from repro_torch.models.ssm import _mlstm_chunk_scan


def mlstm_ref(q, k, v, log_f, i_gate):
    """The chunk-1 mLSTM recurrence from a zero state, in f32;
    q/k/v (b, h, s, dh)."""
    b, h, s, dh = q.shape
    f32 = torch.float32
    s0 = torch.zeros((b, h, dh, dh), dtype=f32, device=q.device)
    n0 = torch.zeros((b, h, dh), dtype=f32, device=q.device)
    y, _, _ = _mlstm_chunk_scan(q.to(f32), k.to(f32), v.to(f32),
                                log_f.to(f32), i_gate.to(f32), s0, n0, 1)
    return y
