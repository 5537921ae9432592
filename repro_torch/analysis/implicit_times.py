"""Times the integer implicit conv's calls of one fused VGG16 forward.

    python -m repro_torch.analysis.implicit_times

Run from the root of a checkout on a machine with an NVIDIA GPU.  It
builds that checkout's ``implicit_conv`` library, prints any spill the
compiler reports for it, times each call that ``chip_smoke.fused_calls``
makes under ``kom_int14`` (VGG16's pooled, plain-epilogue and handoff convs
at batch 8, AlexNet conv2 and conv3 at batch 16; CUDA events over 20
launches after 3 warm-up launches) and prints the VGG16 sums per variant.

Two versions are compared within one session on one card, in turns
(parent, change, change, parent): in a checkout without this module (a
parent commit), run this file by its path from that checkout's root with
``PYTHONPATH=.``, so that ``chip_smoke`` and ``repro_torch`` come from
there.
"""
from __future__ import annotations

import os
import sys


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("implicit_times needs an NVIDIA GPU")
    build.build(["implicit_conv"])
    for kernel, line in build.compiler_report("implicit_conv"):
        if build.spills(line):
            print("   ", kernel, line)
    tag = os.path.basename(os.getcwd())
    gen = torch.Generator().manual_seed(2)
    sums = {}
    for name, label, run, _, _ in chip_smoke.fused_calls(
            torch, "kom_int14", gen, torch.device("cuda")):
        ms = chip_smoke.cuda_ms(run, iters=20, warmup=3)
        if label.startswith("v"):
            sums[name] = sums.get(name, 0.0) + ms
        print(f"{tag} {name} {label} {ms:.4f}")
    print(tag, "VGG16 sums", {k: round(v, 4) for k, v in sums.items()})


if __name__ == "__main__":
    main()
