"""The tensor cores' own rounding in one bf16 MMA, measured on the card.

    python -m repro_torch.analysis.mma_probe [--count 4096] [--seed 0]

The float conv kernel's bf16 schedules run each limb pair as ``mma.sync
m16n8k16`` bf16 x bf16 -> f32 (``csrc/implicit_conv_float.cu``).  A bf16
product is exact in f32, but the tensor core adds a k16 step's sixteen
products and the accumulator with its own alignment and rounding, not
IEEE round-to-nearest at each add.  This probe runs ``count`` single MMAs
on random bf16 values (one warp each, the library's ``mma_probe_launch``)
and holds every output against the exact value and three models of the
sum:

* ``rne``: the exact sum rounded to nearest f32;
* ``rtz``: the exact sum rounded toward zero -- the pessimistic model the
  CPU tests emulate at VGG16's deepest K (``tests/test_torch_float.py``);
* ``align+g``: every addend truncated toward zero to the grid ``2^(e - 23
  - g)`` of the largest addend's exponent ``e``, summed exactly, then
  rounded toward zero (``g`` guard bits).

It reports the share of outputs bitwise equal to each model and the
largest error in units of ``2^(e - 23)``.  Two cases: C = 0 (the kernel's
first pair, from a zeroed fragment) and C of the products' size (each
later pair).  Magnitudes are kept within a window where every f64 sum
here is exact.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.kernels import build

GUARDS = (0, 1, 2, 3)


def rtz_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 ``x`` rounded toward zero to f32 (returned as f64)."""
    y = x.to(torch.float32)
    over = y.to(torch.float64).abs() > x.abs()
    y = torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)
    return y.to(torch.float64)


def align_rtz(terms: torch.Tensor, guard: int = 0) -> torch.Tensor:
    """The sum over the last axis of f64 ``terms`` with each addend cut
    toward zero to the grid of the largest one's exponent minus ``23 +
    guard`` bits, then rounded toward zero to f32."""
    mx = terms.abs().amax(dim=-1, keepdim=True)
    e = torch.floor(torch.log2(torch.where(mx > 0, mx, torch.ones_like(mx))))
    grid = torch.exp2(e - 23 - guard)
    return rtz_f32((torch.trunc(terms / grid) * grid).sum(dim=-1))


def probe_inputs(count: int, seed: int, *, zero_c: bool):
    """A (count, 16, 16) and B (count, 16, 8) bf16, C (count, 16, 8) f32:
    random signs, magnitudes 2^-4..4 times 2^-2..2^2 (so every f64 sum of
    the products and C is exact)."""
    rng = np.random.default_rng(seed)

    def vals(shape):
        mag = np.clip(np.abs(rng.standard_normal(shape)), 2.0 ** -4, 4.0)
        sign = rng.choice([-1.0, 1.0], size=shape)
        return torch.from_numpy(sign * mag * 2.0 ** rng.integers(-2, 3, shape)
                                ).to(torch.bfloat16)
    a, b = vals((count, 16, 16)), vals((count, 16, 8))
    c = (torch.zeros((count, 16, 8)) if zero_c else torch.from_numpy(
        rng.standard_normal((count, 16, 8)) * 4.0).to(torch.float32))
    return a, b, c


def terms_of(a, b, c) -> torch.Tensor:
    """(count, 16, 8, 17) f64: the sixteen exact products, then C."""
    prods = a.double()[:, :, :, None] * b.double()[:, None, :, :]
    return torch.cat([prods.permute(0, 1, 3, 2),
                      c.double()[..., None]], dim=-1)


def mma_on_card(a, b, c) -> torch.Tensor:
    """D = A B + C by one ``mma.sync`` per (16, 16) x (16, 8) tile."""
    from repro_torch.kernels.conv2d.implicit_gemm import (FLOAT_LIB,
                                                          _FLOAT_ARGTYPES)
    dev = torch.device("cuda")
    a, b, c = (t.to(dev).contiguous() for t in (a, b, c))
    d = torch.empty_like(c)
    lib = build.library(FLOAT_LIB, _FLOAT_ARGTYPES)
    code = lib.mma_probe_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                d.data_ptr(), a.shape[0], build.stream_ptr(a))
    build.check_launch(lib, code, "mma_probe")
    torch.cuda.synchronize()
    return d.cpu()


def compare(d: torch.Tensor, terms: torch.Tensor) -> dict:
    """Share of ``d`` bitwise equal to each model, and the largest error
    from the exact sum in units of the top addend's f32 grid."""
    exact = terms.sum(dim=-1)
    d = d.double()
    models = {"rne": exact.to(torch.float32).double(), "rtz": rtz_f32(exact)}
    for g in GUARDS:
        models[f"align+{g}"] = align_rtz(terms, g)
    mx = terms.abs().amax(dim=-1)
    grid = torch.exp2(torch.floor(torch.log2(torch.where(
        mx > 0, mx, torch.ones_like(mx)))) - 23)
    err = (d - exact).abs() / grid
    return {"outputs": d.numel(),
            "bitwise": {k: float((d == v).double().mean())
                        for k, v in models.items()},
            "max_err_grid": float(err.max()),
            "toward_zero": float(((d - exact) * exact.sign() <= 0)
                                 .double().mean())}


def run(count: int = 4096, seed: int = 0) -> dict:
    """Both cases on the card: ``{"c=0": ..., "c!=0": ...}``."""
    if not torch.cuda.is_available():
        raise RuntimeError("the MMA probe needs an NVIDIA GPU")
    out = {}
    for zero_c in (True, False):
        a, b, c = probe_inputs(count, seed, zero_c=zero_c)
        out["c=0" if zero_c else "c!=0"] = compare(mma_on_card(a, b, c),
                                                   terms_of(a, b, c))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--count", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      **run(args.count, args.seed)}))


if __name__ == "__main__":
    main()
