"""Times the flash-attention kernels and the chunkwise-mLSTM kernels at
their full-width shapes, and the granite-3-2b fp32 prefill step.

    python -m repro_torch.analysis.lm_kernel_times [--no-prefill]

Run from the root of a checkout on a machine with an NVIDIA GPU.  It
builds that checkout's ``flash_attention`` and ``mlstm_chunk`` libraries,
prints any spill the compiler reports for them, and times (CUDA events,
``chip_smoke.cuda_ms``, after warm-up launches):

* f32 flash attention at one granite-3-2b prefill layer (b 4, hq 32, hkv
  8, sq = skv = 2048, dh 64, causal), bf16 attention at the same layer,
  both dtypes at one olmoe-1b-7b prefill layer (b 4, hq = hkv = 16, sq =
  skv = 2048, dh 128, causal), and flash decode (b 8, hq 32, hkv 8, S
  4096, dh 64, pos 4095; f32 and bf16, device time replayed from a CUDA
  graph, as ``chip_smoke.py`` times it);
* the chunkwise mLSTM in f32 at one xlstm-125m layer (b 4, h 4, 2048
  tokens, dh 384, chunk 64) and at 1 x 4 x 32768;
* unless ``--no-prefill``: the full-width granite-3-2b prefill step on 4 x
  2048 tokens under ``fp32`` (TF32 off) with the flash kernel, the mean of
  three steps after one warm-up (host clock around synchronised steps).

Beside each kernel time it prints how far the kernel and its plain version
lie from the same function in f64 (the attention oracle, the model's chunk
loop), of max |f64|: each one's own error, where the checks hold the two
against each other.

Two versions are compared within one run on one card, in turns
(parent, change, change, parent): in a checkout without this module (a
parent commit), run this file by its path from that checkout's root with
``PYTHONPATH=.``, so that ``chip_smoke`` and ``repro_torch`` come from
there.
"""
from __future__ import annotations

import os
import sys
import time


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    from repro_torch.models import ssm

    if not torch.cuda.is_available():
        raise SystemExit("lm_kernel_times needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = ("flash_attention", "flash_decode", "mlstm_chunk")
    build.build(names)
    for name in names:
        for kernel, line in build.compiler_report(name):
            if build.spills(line):
                print("   ", name, kernel, line)
    tag = os.path.basename(os.getcwd())
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")

    def f64_gap(got, want, ref):
        """The kernel's and the plain version's distances from the f64
        output, of max |f64|."""
        scale = float(ref.abs().max())
        far = lambda t: float((t.double() - ref).abs().max()) / scale
        return f"kernel-f64 {far(got):.3e} plain-f64 {far(want):.3e}"

    q, k, v = rnd(4, 32, 2048, 64), rnd(4, 8, 2048, 64), rnd(4, 8, 2048, 64)
    ms = chip_smoke.cuda_ms(lambda: flash_attention(q, k, v), iters=20,
                            warmup=3)
    got = flash_attention(q[:1], k[:1], v[:1])
    with build.plain_versions():
        want = flash_attention(q[:1], k[:1], v[:1])
    ref = attention_ref(*(t[:1].double() for t in (q, k, v)))
    print(f"{tag} flash_attention f32 4x32x2048 dh64 {ms:.4f} "
          f"(batch 0: {f64_gap(got, want, ref)})")
    del got, want, ref
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    ms = chip_smoke.cuda_ms(lambda: flash_attention(qb, kb, vb), iters=20,
                            warmup=3)
    print(f"{tag} flash_attention bf16 4x32x2048 dh64 {ms:.4f}")
    del q, k, v, qb, kb, vb
    for dt in (torch.float32, torch.bfloat16):
        x = tuple(rnd(4, 16, 2048, 128).to(dt) for _ in range(3))
        ms = chip_smoke.cuda_ms(lambda: flash_attention(*x), iters=20,
                                warmup=3)
        print(f"{tag} flash_attention {str(dt)[6:]} 4x16x2048 dh128 "
              f"{ms:.4f}")
    del x
    q, kc, vc = rnd(8, 32, 1, 64), rnd(8, 8, 4096, 64), rnd(8, 8, 4096, 64)
    for dt in (torch.float32, torch.bfloat16):
        x = tuple(t.to(dt) for t in (q, kc, vc))
        ms = chip_smoke.cuda_graph_ms(lambda: flash_decode(*x, 4095),
                                      iters=20)
        print(f"{tag} flash_decode {str(dt)[6:]} S4096 pos4095 {ms:.4f}")
    del q, kc, vc, x
    for b, s in ((4, 2048), (1, 32768)):
        x = chip_smoke.mlstm_inputs(torch, b, 4, s, 384, 0)
        ms = chip_smoke.cuda_ms(lambda: mlstm_chunk(*x, chunk=64),
                                iters=10, warmup=2)
        got = mlstm_chunk(*x, chunk=64)
        with build.plain_versions():
            want = mlstm_chunk(*x, chunk=64)
        z = torch.zeros
        ref, _, _ = ssm._mlstm_chunk_scan(
            *(t.double() for t in x),
            z((b, 4, 384, 384), dtype=torch.float64, device="cuda"),
            z((b, 4, 384), dtype=torch.float64, device="cuda"), 64)
        print(f"{tag} mlstm_chunk f32 {b}x4x{s} dh384 {ms:.4f} "
              f"({f64_gap(got, want, ref)})")
        del x, got, want, ref
    torch.cuda.empty_cache()
    if "--no-prefill" in sys.argv:
        return
    from repro_torch.configs import get_config
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.launch.step_fns import make_prefill_step

    params = chip_smoke.lm_params(torch)
    cfg = get_config("granite-3-2b", use_flash_kernel=True).replace(
        policy=MatmulPolicy.FP32, compute_dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 2048)).astype(np.int64)).cuda()
    step = make_prefill_step(cfg)
    step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 3
    print(f"{tag} granite-3-2b fp32 prefill 4x2048 {1e3 * dt:.1f} ms "
          f"{4 * 2048 / dt:.0f} tokens/s")


if __name__ == "__main__":
    main()
