"""The three-pass TF32 arithmetic's two hardware facts, measured on the card.

    python -m repro_torch.analysis.tf32_probe [--count 200000] [--seed 0]

The f32 flash-attention kernel and the chunkwise-mLSTM kernels split every
f32 operand x into ``big = tf32(x)`` and ``small = tf32(x - big)``
(``csrc/tf32x3.cuh``) and run each product as three TF32 ``mma.sync
m16n8k8`` passes.  This probe checks the two things the CPU tests and the
roofline take on trust:

* ``split``: the card's split (the library's ``tf32_split_probe_launch``,
  the kernels' own ``to_tf32``) against :func:`split` on hand-picked ties,
  signs and subnormals and on ``count`` random bit patterns (every finite
  f32 is a candidate): the share bitwise equal, big and small alike;
* ``mma_rate``: TF32 TFLOP/s of ``mma.sync`` m16n8k8 with 4 or 8
  independent accumulator chains per warp and 4, 8 or 16 warps per SM
  (``tf32_mma_rate_launch``, CUDA events), the ceiling that three passes
  through ``mma.sync`` meet before any other work -- beside the published
  dense TF32 peak (``analysis/roofline.H100``).

Prints one JSON line with the card's name.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.kernels import build

#: Hand-picked bit patterns: 1, ties at 1 + 2^-11 (both signs, and one that
#: carries into the exponent), either side of a tie, subnormal ties and
#: near-ties, the zeros, -123.456, and 1 + 3 * 2^-11.
HAND_PICKED = (0x3F800000, 0x3F801000, 0xBF801000, 0x3F800FFF, 0x3F801001,
               0x3F7FF000, 0x00001000, 0x80000FFF, 0x00000800, 0x00000000,
               0x80000000, 0xC2F6E979, 0x3F803000)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` with the low 13 bits cleared: add half of the
    dropped bits' weight to the magnitude's bit pattern, then clear them
    (round to nearest, ties away from zero)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    r = ((bits & 0xFFFFFFFF) + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    """(big, small) as the kernels split x: ``x - big`` is exact in f32."""
    big = tf32(x)
    return big, tf32(x - big)


def probe_values(count: int, seed: int) -> torch.Tensor:
    """HAND_PICKED, then ``count`` random finite f32 bit patterns."""
    bits = np.random.default_rng(seed).integers(0, 2 ** 32, count,
                                                dtype=np.uint64)
    bits = bits.astype(np.uint32)
    bits = bits[(bits & 0x7F800000) != 0x7F800000]  # no inf or nan
    allv = np.concatenate([np.array(HAND_PICKED, np.uint32), bits])
    return torch.from_numpy(allv.view(np.float32).copy())


def _lib():
    from repro_torch.kernels.flash_attention.flash_attention import (
        _ARGTYPES, NAME)
    return build.library(NAME, _ARGTYPES)


def split_on_card(x: torch.Tensor):
    """The card's (big, small) of every value of ``x`` (f32, any device)."""
    lib = _lib()
    xc = x.to(torch.float32).cuda().contiguous()
    big = torch.empty_like(xc)
    small = torch.empty_like(xc)
    code = lib.tf32_split_probe_launch(xc.data_ptr(), big.data_ptr(),
                                       small.data_ptr(), xc.numel(),
                                       build.stream_ptr(xc))
    build.check_launch(lib, code, "tf32_split_probe")
    torch.cuda.synchronize()
    return big.cpu(), small.cpu()


def mma_rate(chains: int, warps_per_sm: int, iters: int = 4096) -> float:
    """TF32 TFLOP/s of ``mma.sync`` m16n8k8, one block per SM."""
    lib = _lib()
    sms = build.num_sms(torch.device("cuda"))
    out = torch.empty(sms * warps_per_sm * 32, device="cuda")
    args = (out.data_ptr(), sms, 32 * warps_per_sm, iters, chains,
            build.stream_ptr(out))
    build.check_launch(lib, lib.tf32_mma_rate_launch(*args), "tf32_mma_rate")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    lib.tf32_mma_rate_launch(*args)
    end.record()
    torch.cuda.synchronize()
    flops = 2.0 * 16 * 8 * 8 * sms * warps_per_sm * iters * chains
    return flops / (start.elapsed_time(end) * 1e-3) / 1e12


def run(count: int = 200000, seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the TF32 probe needs an NVIDIA GPU")
    from repro_torch.analysis.roofline import H100
    x = probe_values(count, seed)
    big, small = split_on_card(x)
    want_big, want_small = split(x)
    same = (big.view(torch.int32) == want_big.view(torch.int32)) & \
        (small.view(torch.int32) == want_small.view(torch.int32))
    rates = {f"chains {c}, {w} warps/SM": round(mma_rate(c, w), 1)
             for c in (4, 8) for w in (4, 8, 16)}
    return {"split": {"values": x.numel(),
                      "bitwise_equal": int(same.sum()),
                      "hand_picked_equal": bool(same[:len(HAND_PICKED)]
                                                .all())},
            "mma_rate_tflops": rates,
            "tf32_peak_tflops": H100["peak_tf32"] / 1e12}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--count", type=int, default=200000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      **run(args.count, args.seed)}))


if __name__ == "__main__":
    main()
