"""How far apart the float schedules lie, and how bf16x3 reacts to ulp noise.

The numbers behind the float checks' tolerances (PERF.md section 2):

* ``gaps``: at VGG16's FC shapes (batch 8, inputs made as ``chip_smoke.py``
  makes them), the relative distance ``max|a - b| / max|b|`` between the
  exact values (:func:`~repro_torch.core.karatsuba.schedule_dot`) of
  bf16x3 and its neighbours native f32, bf16x4 and bf16x6.  A kernel
  check whose tolerance is below these can tell the schedules apart.
* ``ulp``: how far a reduced model's logits move when half the input
  pixels move by one f32 ulp, under ``fp32``, ``bf16x3`` and ``bf16x6``
  (plain versions; random weights, biases 0.1 * randn).  A forward-level
  check cannot be tighter than this under bf16x3, whose low bf16 limb can
  jump by 2^7 input ulps.

    python -m repro_torch.analysis.float_tolerance [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.karatsuba import schedule_dot


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def schedule_gaps(device: str = "cpu", seed: int = 3) -> list:
    """[(k, n, {neighbour passes: gap to bf16x3})] at VGG16's FC shapes."""
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for k, n in ((25088, 4096), (4096, 4096), (4096, 1000)):
        a = torch.relu(torch.randn((8, k), generator=gen)).to(device)
        b = (torch.randn((k, n), generator=gen) * k ** -0.5).to(device)
        x3 = schedule_dot(a, b, passes=3)
        rows.append((k, n, {p: _rel(schedule_dot(a, b, passes=p), x3)
                            for p in (1, 4, 6)}))
    return rows


def ulp_sensitivity(arch: str, device: str = "cpu", seed: int = 0) -> dict:
    """{policy: relative move of the logits} when half the input pixels of
    a reduced ``arch`` forward move by one f32 ulp (implicit engine)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.models.cnn import cnn_forward, cnn_init

    cfg = reduced(get_config(arch, conv_path="implicit"))
    gen = torch.Generator().manual_seed(seed)
    params = cnn_init(cfg, gen, device=device)
    for p in params:                  # biases as the checks make them
        if "b" in p:
            p["b"] = (0.1 * torch.randn(p["b"].shape, generator=gen)).to(
                device)
    x = torch.randn((2, cfg.img_size, cfg.img_size, 3), generator=gen)
    moved = torch.where(torch.rand(x.shape, generator=gen) < 0.5,
                        torch.nextafter(x, torch.full_like(x, float("inf"))),
                        x)
    out = {}
    with torch.inference_mode(), build.plain_versions():
        for policy in ("fp32", "bf16x3", "bf16x6"):
            c = cfg.replace(policy=MatmulPolicy(policy))
            base = cnn_forward(params, c, x.to(device))
            out[policy] = _rel(cnn_forward(params, c, moved.to(device)), base)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    for k, n, gaps in schedule_gaps(args.device):
        print(f"gaps 8x{k}x{n}: bf16x3 vs native {gaps[1]:.3e}, "
              f"vs bf16x4 {gaps[4]:.3e}, vs bf16x6 {gaps[6]:.3e}")
    for arch in ("alexnet", "vgg16", "vgg19"):
        moves = ulp_sensitivity(arch, args.device)
        print(f"ulp {arch}: " + ", ".join(f"{p} {v:.3e}"
                                          for p, v in moves.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
