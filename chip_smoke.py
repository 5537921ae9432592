#!/usr/bin/env python3
"""Proof on an NVIDIA GPU that the port's integer AlexNet path runs.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. report the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the three CUDA kernels from ``repro_torch/csrc`` (one ``nvcc``
   per source, all at once) and print the build time;
3. hold each kernel against its plain PyTorch version on the card at
   AlexNet's full-width shapes (batch 16) under ``kom_int14`` and
   ``schoolbook_int16``: max abs difference must be 0; time both, and time
   the limb GEMM's three int8 passes through ``torch._int_mm`` as a
   yardstick (no single PyTorch call computes the convs' quantized limb
   arithmetic);
4. serve full-width AlexNet under ``kom_int14`` through ``CNNServeEngine``
   (buckets 1/4/16): warm up, then 32 requests; every request must
   complete, the launch counters must show 1 implicit-conv, 3 Winograd and
   4 limb-GEMM launches per forward, the logits must equal a forward
   through the plain versions on the card bit for bit, and a reduced
   AlexNet forward on the card must equal the plain version on the CPU
   (which the CPU tests hold against the JAX reference) bit for bit;
5. print a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, without a CUDA device or without the
``repro_torch`` package beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

#: The card's published peaks (NVIDIA H100 SXM data sheet, dense): int8
#: tensor-core operations per second and HBM bytes per second.
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12

BATCH = 16
POLICIES = ("kom_int14", "schoolbook_int16")
#: Where each ported kernel came from (the Pallas kernel's definition).
REPLACES = {
    "kom_matmul": "src/repro/kernels/kom_matmul/kom_matmul.py:27",
    "implicit_conv": "src/repro/kernels/conv2d/implicit_gemm.py:131",
    "winograd": "src/repro/kernels/conv2d/winograd.py:416",
}
SOURCES = {
    "kom_matmul": "repro_torch/csrc/kom_matmul.cu",
    "implicit_conv": "repro_torch/csrc/implicit_conv.cu",
    "winograd": "repro_torch/csrc/winograd.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms (CUDA events around ``iters``)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version, AlexNet shapes.
# ---------------------------------------------------------------------------

def alexnet_calls(torch, policy: str, gen, dev) -> list:
    """One (kernel, label, run, ops, bytes) per kernel call of an AlexNet
    forward at batch 16; ``run()`` calls the kernel's raw wrapper on inputs
    made the way the serving path makes them."""
    import torch.nn.functional as F

    from repro_torch.core.substrate import INT_POLICY_SPECS, kom_qmax
    from repro_torch.kernels.conv2d.implicit_gemm import conv2d_implicit_raw
    from repro_torch.kernels.conv2d.ops import patch_scales
    from repro_torch.kernels.conv2d.winograd import (
        channel_absmax, conv2d_winograd_raw, tile_scales_from_cmax,
        winograd_weight_planes)
    from repro_torch.kernels.kom_matmul import kom_matmul_int

    variant, bb = INT_POLICY_SPECS[policy]
    passes = 3 if variant == "karatsuba" else 4
    qmax = kom_qmax(bb)

    def ints(shape):
        return torch.randint(-qmax, qmax + 1, shape, generator=gen,
                             dtype=torch.int32).to(torch.int16).to(dev)

    def pos(shape):
        return (torch.rand(shape, generator=gen) * 1e-3 + 1e-4).to(dev)

    def randn(shape):
        return torch.randn(shape, generator=gen).to(dev)

    calls = []
    # Limb GEMM: the stem's im2col GEMM and the three FC layers.
    for label, (m, k, n) in (("stem", (3025 * BATCH, 363, 96)),
                             ("fc6", (BATCH, 9216, 4096)),
                             ("fc7", (BATCH, 4096, 4096)),
                             ("fc8", (BATCH, 4096, 1000))):
        a, b = ints((m, k)), ints((k, n))
        rs, cs, bias = pos((m,)), pos((n,)), randn((n,))
        run = (lambda a=a, b=b, rs=rs, cs=cs, bias=bias: kom_matmul_int(
            a, b, variant=variant, base_bits=bb, row_scale=rs, col_scale=cs,
            bias=bias))
        nbytes = 2 * (m * k + k * n) + 4 * (m + 2 * n + m * n)
        calls.append(("kom_matmul", label, run, 2.0 * m * k * n * passes,
                      nbytes, (a, b)))
    # Implicit GEMM: conv2, 5x5 96 -> 256 at 27x27, SAME.
    x = torch.relu(randn((BATCH, 27, 27, 96)))
    wv = ints((5, 5, 96, 256))
    cmax = F.pad(channel_absmax(x), (2, 2, 2, 2))
    asc = patch_scales(cmax, 5, 5, 1, qmax).contiguous()
    ws, bias = pos((256,)), randn((256,))
    run = (lambda x=x, wv=wv, asc=asc, ws=ws, bias=bias: conv2d_implicit_raw(
        x, wv, asc, ws, bias, stride=1, pads=(2, 2), out_hw=(27, 27),
        span_c=96, variant=variant, base_bits=bb))
    ops = 2.0 * BATCH * 27 * 27 * 256 * 25 * 96 * passes
    nbytes = 4 * x.numel() + 2 * wv.numel() + 4 * asc.numel() + 8 * 256 \
        + 4 * BATCH * 27 * 27 * 256
    calls.append(("implicit_conv", "conv2", run, ops, nbytes, (x, wv)))
    # Winograd: conv3-5, 3x3 at 13x13, SAME.
    for label, cin, cout in (("conv3", 256, 384), ("conv4", 384, 384),
                             ("conv5", 384, 256)):
        x = torch.relu(randn((BATCH, 13, 13, cin)))
        uh, ul = winograd_weight_planes(ints((3, 3, cin, cout)), bb)
        s_tile = tile_scales_from_cmax(
            F.pad(channel_absmax(x), (1, 1, 1, 1)), qmax, 7, 7).contiguous()
        ws4, bias = pos((cout,)), randn((cout,))
        run = (lambda x=x, uh=uh, ul=ul, s=s_tile, ws4=ws4, bias=bias:
               conv2d_winograd_raw(x, uh, ul, s, ws4, bias, pads=(1, 1),
                                   out_hw=(13, 13), variant=variant,
                                   base_bits=bb))
        ops = 2.0 * 16 * BATCH * 49 * cin * cout * passes
        nbytes = 4 * x.numel() + 2 * (uh.numel() + ul.numel()) \
            + 4 * s_tile.numel() + 8 * cout + 4 * BATCH * 13 * 13 * cout
        calls.append(("winograd", label, run, ops, nbytes, (x, uh)))
    return calls


def int_mm_passes_ms(torch, a16, b16, variant, bb) -> float | None:
    """Yardstick: the limb GEMM's three (or four) int8 passes as
    ``torch._int_mm`` calls on pre-split, padded digit planes."""
    from repro_torch.core.substrate import balanced_split

    m, k = a16.shape
    n = b16.shape[1]
    mp, kp, np_ = max(-(-m // 8) * 8, 24), -(-k // 8) * 8, -(-n // 8) * 8
    pad_a = lambda t: torch.nn.functional.pad(t, (0, kp - k, 0, mp - m))
    pad_b = lambda t: torch.nn.functional.pad(t, (0, np_ - n, 0, kp - k))
    ah, al = balanced_split(a16, bb)
    bh, bl = balanced_split(b16, bb)
    A = [pad_a(t).to(torch.int8).contiguous() for t in (ah, al, ah + al)]
    B = [pad_b(t).to(torch.int8).contiguous() for t in (bh, bl, bh + bl)]
    pairs = [(0, 0), (1, 1), (2, 2)] if variant == "karatsuba" \
        else [(0, 0), (1, 1), (0, 1), (1, 0)]

    def run():
        for i, j in pairs:
            torch._int_mm(A[i], B[j])
    try:
        return cuda_ms(run, iters=10)
    except RuntimeError as e:  # shape constraints of this torch build
        log(f"  library yardstick unavailable: {e}")
        return None


def phase_compare(torch) -> dict:
    from repro_torch.core.substrate import INT_POLICY_SPECS
    from repro_torch.kernels import build

    gen = torch.Generator().manual_seed(0)
    summary = {}
    for policy in POLICIES:
        variant, bb = INT_POLICY_SPECS[policy]
        for name, label, run, ops, nbytes, args in alexnet_calls(
                torch, policy, gen, torch.device("cuda")):
            got = run()
            with build.plain_versions():
                want = run()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            nan = bool(torch.isnan(got).any() or torch.isnan(want).any())
            same = torch.equal(got, want)
            ms = cuda_ms(run, iters=10)
            with build.plain_versions():
                plain_ms = cuda_ms(run, iters=3, warmup=1)
            lib_ms = None
            if name == "kom_matmul":
                lib_ms = int_mm_passes_ms(torch, args[0], args[1], variant,
                                          bb)
            b_ms, b_by = bound_ms(ops, nbytes)
            log(f"[compare] {policy:16s} {name:13s} {label:5s} "
                f"shape={tuple(got.shape)} max_abs_err={err} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
                f"bound_ms={b_ms:.5f} ({b_by})")
            if nan or not same or err != 0.0:
                raise SystemExit(f"{name}/{label}/{policy}: kernel != plain "
                                 f"(max_abs_err={err}, nan={nan})")
            if policy == "kom_int14":
                s = summary.setdefault(name, {
                    "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "library_ms": 0.0 if name == "kom_matmul" else None,
                    "max_abs_err": 0.0, "ops": 0.0, "bytes": 0.0})
                s["ms"] += ms
                s["plain_ms"] += plain_ms
                s["ops"] += ops
                s["bytes"] += nbytes
                s["max_abs_err"] = max(s["max_abs_err"], err)
                if s["library_ms"] is not None:
                    s["library_ms"] = None if lib_ms is None \
                        else s["library_ms"] + lib_ms
    log("[compare] the implicit and Winograd convs have no single PyTorch "
        "call computing the same quantized limb arithmetic: library_ms null")
    for s in summary.values():
        s["bound_ms"], s["bound_by"] = bound_ms(s["ops"], s["bytes"])
    return summary


# ---------------------------------------------------------------------------
# Phase 4: serve full-width AlexNet through the kernels.
# ---------------------------------------------------------------------------

def random_biases(torch, params: list, gen) -> list:
    """``cnn_init`` zeroes every bias; fill them (0.1 * randn from ``gen``)
    so the bitwise checks cover each layer's bias epilogue."""
    for p in params:
        if "b" in p:
            p["b"] = (0.1 * torch.randn(p["b"].shape, generator=gen)).to(
                p["b"].device)
    return params


def phase_serve(torch, card: str) -> dict:
    import numpy as np

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.models.cnn import (cnn_forward, cnn_init,
                                        cnn_quantize_params)
    from repro_torch.serving.cnn_engine import (CNNServeEngine, ImageRequest,
                                                params_to)

    cfg = get_config("alexnet", policy=MatmulPolicy.KOM_INT14)
    gen = torch.Generator().manual_seed(0)
    params = random_biases(torch, cnn_init(cfg, gen, device="cuda"), gen)
    eng = CNNServeEngine(cfg, params, buckets=(1, 4, 16), device="cuda")
    t0 = time.perf_counter()
    eng.warmup()
    log(f"[serve] warmup {time.perf_counter() - t0:.2f}s "
        f"(buckets {eng.buckets})")
    rng = np.random.default_rng(0)
    n_req = 32
    imgs = rng.standard_normal((n_req, 227, 227, 3)).astype(np.float32)
    steps0 = eng.batcher.steps
    build.reset_launches()
    t0 = time.perf_counter()
    for uid in range(n_req):
        eng.submit(ImageRequest(uid=uid, image=imgs[uid]))
    done = eng.run()
    wall = time.perf_counter() - t0
    launches = build.launch_counts()
    forwards = eng.batcher.steps - steps0
    if sorted(done) != list(range(n_req)):
        raise SystemExit(f"served {len(done)} of {n_req} requests")
    want = {"implicit_conv": forwards, "winograd": 3 * forwards,
            "kom_matmul": 4 * forwards}
    log(f"[serve] {forwards} forwards, launches {launches}, "
        f"expected {want}")
    if launches != want:
        raise SystemExit(f"launch counts {launches} != {want}")
    logits = np.stack([done[u].logits for u in range(n_req)])
    if logits.shape != (n_req, 1000) or not np.isfinite(logits).all():
        raise SystemExit(f"bad logits: shape {logits.shape}, "
                         f"finite {np.isfinite(logits).all()}")
    x_all = torch.from_numpy(imgs).cuda()
    with build.plain_versions():
        plain = eng.forward(x_all).cpu().numpy()
    if not np.array_equal(plain, logits):
        raise SystemExit(f"engine logits != plain forward on the card "
                         f"(max diff {np.abs(plain - logits).max()})")
    log("[serve] engine logits == plain-version forward on the card, "
        "bitwise")
    fp32 = cfg.replace(policy=MatmulPolicy.FP32)
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        ref = cnn_forward(params, fp32, x_all[:4]).cpu().numpy()
    rel = float(np.abs(logits[:4] - ref).max() / np.abs(ref).max())
    top1 = float(np.mean(logits[:4].argmax(1) == ref.argmax(1)))
    log(f"[serve] kom_int14 vs fp32 logits: max rel err {rel:.3e}, "
        f"top-1 agreement {top1}")
    if not rel < 1e-2:
        raise SystemExit(f"kom_int14 logits too far from fp32 ({rel})")
    # Small input: kernels on the card == plain versions on the CPU.
    rcfg = reduced(cfg)
    gen = torch.Generator().manual_seed(1)
    rp = cnn_quantize_params(
        random_biases(torch, cnn_init(rcfg, gen, device="cpu"), gen), rcfg)
    xs = torch.from_numpy(rng.standard_normal(
        (2, rcfg.img_size, rcfg.img_size, 3)).astype(np.float32))
    with torch.inference_mode():
        cpu_out = cnn_forward(rp, rcfg, xs).numpy()
        gpu_out = cnn_forward(params_to(rp, "cuda"), rcfg,
                              xs.cuda()).cpu().numpy()
    if not np.array_equal(cpu_out, gpu_out):
        raise SystemExit("reduced AlexNet: card kernels != CPU plain "
                         f"versions (max diff {np.abs(cpu_out - gpu_out).max()})")
    log("[serve] reduced AlexNet: kernels on the card == plain versions on "
        "the CPU, bitwise")
    phase_profile(torch, eng, imgs[:BATCH])
    s = eng.stats()
    log(f"[serve] alexnet/kom_int14 on {card}: {s['images_done']} images, "
        f"{s['images_per_s']:.1f} img/s batched, {n_req / wall:.1f} img/s "
        f"wall, p50 latency {1e3 * s['latency_p50_s']:.2f} ms, "
        f"p95 latency {1e3 * s['latency_p95_s']:.2f} ms, "
        f"buckets {s['bucket_counts']}")
    return launches


def phase_profile(torch, eng, batch) -> None:
    """Where one 16-image serving step (host batch in, host logits out)
    spends its time: its wall clock, and from ``torch.profiler`` the device
    time of every kernel and copy by name; device busy = the union of their
    intervals on the device timeline, idle = the profiled step's wall clock
    minus busy (an upper bound: the profiler slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng.run_batch(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_batch(batch)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_batch(batch)  # ends in a copy to the host: synchronized
        prof_wall_ms = 1e3 * (time.perf_counter() - t0)
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0_us, t1_us = e.time_range.start, e.time_range.end
        spans.append((t0_us, t1_us))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + (t1_us - t0_us))
    if not spans:
        log("[profile] device time not measured: the profiler recorded no "
            "device events")
        return
    busy_us, end = 0.0, None
    for t0_us, t1_us in sorted(spans):
        if end is None or t0_us > end:
            busy_us += t1_us - t0_us
            end = t1_us
        elif t1_us > end:
            busy_us += t1_us - end
            end = t1_us
    busy = busy_us / 1e3
    log(f"[profile] one {len(batch)}-image step: wall {wall_ms:.3f} ms "
        f"({prof_wall_ms:.3f} ms profiled), device busy {busy:.3f} ms, "
        f"idle {100 * (1 - busy / prof_wall_ms):.1f}% of the profiled step")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :14]:
        log(f"[profile]   {us / 1e3:9.4f} ms  x{n:<3d} {name[:100]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = nvidia_smi_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        "device(s)")
    t0 = time.perf_counter()
    took = build.build()
    log(f"[build] {len(took)} libraries in {time.perf_counter() - t0:.1f}s "
        f"wall: " + ", ".join(f"{k} {v:.1f}s" for k, v in took.items()))
    for name in build.SOURCES:
        for line in build.compiler_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    summary = phase_compare(torch)
    launches = phase_serve(torch, card)
    kernels = []
    for name in ("kom_matmul", "implicit_conv", "winograd"):
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
