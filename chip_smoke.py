#!/usr/bin/env python3
"""Proof on an NVIDIA GPU that the port's AlexNet, VGG16, granite-3-2b and
xlstm-125m paths run.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. report the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the CUDA kernels from ``repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the build time; count the int8 MMA
   opcodes (IMMA) in the SASS: the limb GEMM and the integer implicit conv
   must issue some, the systolic and Winograd convs none;
3. hold each kernel against its plain PyTorch version on the card at
   AlexNet's full-width shapes (batch 16) under ``kom_int14`` and
   ``schoolbook_int16``: max abs difference must be 0; time both, and time
   the limb GEMM's three int8 passes through ``torch._int_mm`` as a
   yardstick (no single PyTorch call computes the convs' quantized limb
   arithmetic);
4. the same for the implicit kernel's pooled and handoff variants at every
   full-width VGG16 producer and consumer shape (batch 8), its plain
   epilogue at VGG16's three convs between them, and at AlexNet's conv2
   (pooled) and conv3 (handoff) (batch 16), both policies; each variant
   summed over one VGG16 forward beside its bound;
5. serve full-width AlexNet under ``kom_int14`` through ``CNNServeEngine``
   on its default (heuristic) plan (buckets 1/4/16): warm up, then 32
   requests; the launch counters, reset just before, must show 1
   implicit-conv, 3 Winograd and 4 limb-GEMM launches per forward, the
   logits must equal a forward through the plain versions on the card bit
   for bit, and a reduced AlexNet forward on the card must equal the plain
   version on the CPU (which the CPU tests hold against the JAX reference)
   bit for bit;
6. serve full-width VGG16 under ``kom_int14`` through the fused plan of
   ``explore(cfg, model_only=True, requant=True)`` (buckets 1/4/8, 16
   requests): the plan must hold ``pool`` and ``pool_quant`` entries, the
   counters, reset just before, must show per forward 4 limb-GEMM, 5
   pooled, 4 handoff and 3 plain implicit-conv launches, the logits must
   equal the plain-version forward on the card bit for bit, and a reduced
   VGG16 forward under its fused plan on the card must equal the CPU plain
   versions bit for bit;
7. count the tensor-core instructions (``HGMMA``, ``HMMA``) in the float
   conv library's SASS (the bf16 schedules must issue ``mma.sync``) and run
   the one-MMA rounding probe (``analysis/mma_probe``: every output within
   17 units of the top addend's f32 grid, the bound of the model the CPU
   tests emulate); then hold the systolic conv
   (``karatsuba``/``schoolbook``: max abs
   difference 0), the float conv kernel (``native``, which the systolic
   engine's ``native`` variant shares, ``bf16x3``, ``bf16x6``) and the
   bf16-limb GEMM (passes 3/4/6) against their plain versions on the card
   (TF32 off) at every full-width VGG16 conv geometry (batch 8) and FC
   shape (the GEMM at 1, 4 and 8 rows; the JSON line's row sums the
   bf16x3 calls at 8), the integer systolic also at AlexNet conv2 (batch
   16).  A float
   plain version is its schedule's exact value rounded once, so a float
   row must satisfy ``max|kernel - plain| <= 1e-6 * max|plain|`` while the
   plain version of the neighbouring schedule (bf16x3 for native, bf16x4
   and bf16x6; native for bf16x3) on the same inputs must miss it.  Times
   beside one PyTorch call for the same function: ``F.conv2d`` (fp32,
   channels-last) for the float convs, ``torch.matmul`` (fp32) for the
   GEMM; each float conv variant's sum over the 13 convs of one forward
   beside ``F.conv2d``'s and the bound;
8. serve full-width VGG16 under ``kom_int14`` with every conv pinned to
   the systolic engine (``conv_path="systolic"``, buckets 1/4/8, 16
   requests): per forward 13 systolic and 3 limb-GEMM launches, logits
   equal to the plain-version forward on the card and to the same image
   served alone, bit for bit; reduced VGG16 and AlexNet on the systolic
   path on the card equal the CPU plain versions bit for bit; then a
   full-width ``fp32`` systolic forward of 4 images (13 native launches),
   the accuracy yardstick: the integer logits within max relative error
   1e-2 of it;
9. serve full-width VGG16 under ``bf16x3`` on the implicit engine
   (buckets 1/4/8, 16 requests): per forward 13 ``implicit_conv_bf16x3``
   and 3 bf16-GEMM launches, logits within 1e-5 relative of the
   plain-version forward on the card and within 1e-3 relative (of max
   |logit|) of the fp32 logits; reduced VGG16 under ``bf16x6`` and
   ``fp32`` (implicit) on the card within 1e-6 of the CPU (which the CPU's
   bf16x3 logits must miss), under ``bf16x3`` within 1e-5.  A whole
   bf16x3 forward cannot be held tighter: moving an input by one f32 ulp
   can move its low bf16 limb by 2^7 times more, so ulp-level differences
   between layers grow to the size of the schedule's own error; phase 7
   holds the schedule itself;
10. count the tensor-core instructions (``HGMMA``, ``HMMA``) in the
    flash-attention library's SASS (``cuobjdump -sass``; the bf16 kernel
    must issue wgmma), then hold the flash-attention kernel against its
    plain version on the card at one full-width granite-3-2b prefill layer
    (b 4, hq 32, hkv 8, sq = skv = 2048, dh 64, causal), at sq 256 with
    q_offset 1792 and with window 512, each in f32 and bf16, and at sq =
    skv = 1000 (padded); the flash-decode kernel at b 8, hq 32, hkv 8, S
    4096, dh 64, pos 0/1000/4095 (f32, and bf16 at 4095 and at 3), -1
    (every key masked) and S 4000 (padded).  f32 within ATTN_TOL_F32 and
    bf16 within ATTN_TOL_BF16, the mutant plain version (causal ``>`` for
    ``>=``; decode ``<`` for ``<=``) required to miss the tolerance (f32;
    bf16 where q_offset is 0, so that the first row's only key is the one
    the mutant drops, and for decode at pos 3, where the dropped key
    carries a quarter of the weight); timed beside
    ``F.scaled_dot_product_attention`` with the same mask (a yardstick the
    port never calls; decode and SDPA also replayed from a CUDA graph,
    device time alone, the JSON row's time) and the ``analysis/roofline``
    bound (bf16 inputs at the bf16 peak); then the decode op's own run (its
    entry point, no model calls it);
11. full-width granite-3-2b (40 layers, random weights, seed 0): the
    prefill step (``make_prefill_step``, ``use_flash_kernel=True``) on 4 x
    2048 tokens under ``native_bf16`` -- 40 flash-attention launches per
    forward, prefill tokens/s, a profile -- and under ``fp32`` (TF32 off)
    the logits within PREFILL_TOL_FP32 of the same forward inside
    ``build.plain_versions()``;
12. the limb GEMM at granite-3-2b's eight decode shapes at m = 1, 4 and
    16, exact against its plain version, with the K split its plan chose,
    eager and CUDA-graph device times, and the per-serve_step totals;
    serve full-width granite-3-2b through ``ServeEngine`` (slots 4,
    max_len 512, 8 requests by the launcher's prompt rule, max_new 12)
    under ``native_bf16`` and ``kom_int14``: all 8 done, decode tokens/s,
    p50/p95 engine-step time, under ``kom_int14`` 281 limb-GEMM launches
    per serve_step, two requests re-served alone with the same greedy
    tokens (the batched-vs-solo max |d logit| printed), a decode profile;
13. reduced granite-3-2b (flash kernel on) under ``fp32`` and
    ``kom_int14``: the forward and four decode steps on the card within
    REDUCED_TOL_FP32 / REDUCED_TOL_KOM of the CPU plain versions;
14. hold the chunkwise-mLSTM kernel against its plain version (the
    model's chunk loop, f32) at one full-width xlstm-125m layer (b 4, h 4,
    s 2048, dh 384, chunk 64) in f32 and bf16, at s 2000 (padded) and 17
    (< chunk), with strong forget gates (log_f ~ -5), with zero input-gate
    rows and at 1 x 4 x 32768 (``prefill_32k``'s length, 512 chunks):
    within MLSTM_TOL of max |plain|, the two mutant plain versions (the
    causal mask without its diagonal, the state written without the input
    gate) required to miss it; timed beside the ``analysis/roofline``
    bound (no PyTorch call computes the chunkwise mLSTM); then the op's
    own run (its entry point, no model calls it, as in the reference);
15. full-width xlstm-125m (12 layers as 3 groups of (m, m, m, s), random
    weights, seed 0): the kernel on the first mLSTM layer's own q/k/v and
    gates from a 4 x 2048 prefill, within MLSTM_TOL of max |y| of that
    layer's chunk loop;
16. the xlstm-125m prefill step on 4 x 2048 tokens under ``native_bf16``
    (no kernel launches: the model's chunk loop is plain PyTorch, as the
    reference's ``lax.scan``) -- tokens/s, a profile with the device time
    under the mLSTM chunk loops and the sLSTM blocks -- and under ``fp32``;
17. serve full-width xlstm-125m through ``ServeEngine`` as phase 12 (70
    limb-GEMM launches per serve_step under ``kom_int14``);
18. reduced xlstm-125m under ``fp32`` and ``kom_int14``: the forward and
    four decode steps on the card within REDUCED_TOL_FP32 /
    REDUCED_TOL_KOM of the CPU plain versions, and ``kom_int14`` on float
    weights (``kom_q_dot`` per tensor) within the measured
    ``analysis/kom_float_weights.FLOAT_WEIGHTS_TOL``, which the card's
    ``base_bits=6`` forward must miss;
19. print the card line, a ``kernels`` JSON line (launches: the serving
    runs, the fp32 yardstick forward, the granite prefill forward and the
    two ops' own runs, each counted from 0) and, last,
    ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, without a CUDA device or without the
``repro_torch`` package beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

BATCH = 16
VGG_BATCH = 8
POLICIES = ("kom_int14", "schoolbook_int16")
#: The float kernels against their plain versions (each schedule's exact
#: value, rounded once): max|kernel - plain| <= FLOAT_TOL * max|plain|,
#: which the plain version of the neighbouring schedule must miss.
FLOAT_TOL = 1e-6
#: Whole bf16x3 forwards, kernels against plain versions (docstring, 9).
FORWARD_TOL_BF16X3 = 1e-5
#: Each float schedule -> the neighbouring one its check must tell it from.
NEIGHBOUR = {"native": "bf16x3", "bf16x3": "native", "bf16x6": "bf16x3"}
#: The attention kernels against their plain versions: f32 outputs (O(1)
#: values, sums in another order) and bf16 outputs (one bf16 ulp).
ATTN_TOL_F32 = 2e-5
ATTN_TOL_BF16 = 2e-2
#: Full-width granite fp32 prefill, flash kernel vs plain version, of max
#: |logit|: 40 layers carry the kernels' f32 reordering through the stack.
PREFILL_TOL_FP32 = 1e-4
#: Reduced granite, card vs CPU, of max |logit|: fp32 (sums in another
#: order), kom_int14 (an ulp can move a 14-bit quantization level).
REDUCED_TOL_FP32 = 1e-5
REDUCED_TOL_KOM = 2e-3
#: The mLSTM kernel against its plain version, of max |plain|, f32 and bf16
#: inputs alike (bf16 is cast to f32 exactly, the output is f32): both run
#: f32 sums in other orders, and the plain version is the noisier one (on
#: an H100 at 4 x 2048, dh 384 it lies ~9e-6 from an f64 run, the kernel
#: ~3e-6).
MLSTM_TOL = 2e-5
XLSTM = "xlstm-125m"
#: The JSON line's kernels: each launch counter of the build's wrappers.
KERNELS = ("kom_matmul", "implicit_conv", "implicit_conv_pool",
           "implicit_conv_handoff", "winograd", "systolic_conv",
           "systolic_conv_native", "implicit_conv_native",
           "implicit_conv_bf16x3", "implicit_conv_bf16x6", "bf16_matmul",
           "flash_attention", "flash_decode", "mlstm_chunk")
_IMPLICIT = "src/repro/kernels/conv2d/implicit_gemm.py:131"
#: Where each ported kernel came from (the Pallas kernel's definition).
REPLACES = {
    "kom_matmul": "src/repro/kernels/kom_matmul/kom_matmul.py:27",
    "implicit_conv": _IMPLICIT,
    "implicit_conv_pool": _IMPLICIT,
    "implicit_conv_handoff": _IMPLICIT,
    "winograd": "src/repro/kernels/conv2d/winograd.py:416",
    "systolic_conv": "src/repro/kernels/conv2d/conv2d.py:78",
    "systolic_conv_native": "src/repro/kernels/conv2d/conv2d.py:78",
    "implicit_conv_native": _IMPLICIT,
    "implicit_conv_bf16x3": _IMPLICIT,
    "implicit_conv_bf16x6": _IMPLICIT,
    "bf16_matmul": "src/repro/kernels/kom_matmul/kom_matmul.py:99",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:26",
    "flash_decode": "src/repro/kernels/flash_decode/flash_decode.py:25",
    "mlstm_chunk": "src/repro/kernels/mlstm_chunk/mlstm_chunk.py:21",
}
SOURCES = {
    "kom_matmul": "repro_torch/csrc/kom_matmul.cu",
    "implicit_conv": "repro_torch/csrc/implicit_conv.cu",
    "implicit_conv_pool": "repro_torch/csrc/implicit_conv.cu",
    "implicit_conv_handoff": "repro_torch/csrc/implicit_conv.cu",
    "winograd": "repro_torch/csrc/winograd.cu",
    "systolic_conv": "repro_torch/csrc/systolic_conv.cu",
    "systolic_conv_native": "repro_torch/csrc/implicit_conv_float.cu",
    "implicit_conv_native": "repro_torch/csrc/implicit_conv_float.cu",
    "implicit_conv_bf16x3": "repro_torch/csrc/implicit_conv_float.cu",
    "implicit_conv_bf16x6": "repro_torch/csrc/implicit_conv_float.cu",
    "bf16_matmul": "repro_torch/csrc/bf16_matmul.cu",
    "flash_attention": "repro_torch/csrc/flash_attention.cu",
    "flash_decode": "repro_torch/csrc/flash_decode.cu",
    "mlstm_chunk": "repro_torch/csrc/mlstm_chunk.cu",
}
#: Full-width VGG16 (h, cin, cout) of each pool-followed conv (pooled
#: variant) and each conv fed by a pool_quant handoff (handoff variant).
VGG16_POOLED = ((224, 64, 64), (112, 128, 128), (56, 256, 256),
                (28, 512, 512), (14, 512, 512))
VGG16_HANDOFF = ((112, 64, 128), (56, 128, 256), (28, 256, 512),
                 (14, 512, 512))
#: ... and each conv between a handoff consumer and a pooled conv (the
#: plain bias_relu epilogue).
VGG16_PLAIN = ((56, 256, 256), (28, 512, 512), (14, 512, 512))
#: Full-width VGG16's FC layers, (k, n).
VGG16_FC = (("fc6", (25088, 4096)), ("fc7", (4096, 4096)),
            ("fc8", (4096, 1000)))
#: The bf16-limb GEMM's compare rows: one request, half a batch, a batch.
GEMM_ROWS = (1, 4, VGG_BATCH)


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


def cuda_graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` in ms with no host time in it: ``iters``
    calls captured in one CUDA graph, replayed between CUDA events (for
    calls shorter than their own Python dispatch)."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(ops: float, nbytes: float, kind: str = "int8"
             ) -> tuple[float, str]:
    """The least time the card could take: the larger of ``ops`` at the
    published peak of the type they run in (``kind``: int8, bf16, fp32)
    and ``nbytes`` at the HBM rate (``repro_torch.analysis.roofline``)."""
    from repro_torch.analysis.roofline import H100
    t_ops, t_bytes = ops / H100["peak_" + kind], nbytes / H100["hbm_bw"]
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_sass_int() -> None:
    """Phase 2b: the integer kernels' tensor-core opcodes (``cuobjdump
    -sass``): the limb GEMM and the integer implicit conv must issue int8
    MMAs (IMMA); the systolic and Winograd convs, still on the CUDA cores,
    none."""
    from repro_torch.kernels import build

    counts = {name: build.sass_count(name, "IMMA")
              for name in ("kom_matmul", "implicit_conv", "systolic_conv",
                           "winograd")}
    log(f"[sass] IMMA (int8 mma.sync) instructions per library: {counts}")
    if not (counts["kom_matmul"] and counts["implicit_conv"]):
        raise SystemExit("[sass] an integer MMA kernel issues no IMMA")
    if counts["systolic_conv"] or counts["winograd"]:
        raise SystemExit("[sass] a CUDA-core integer kernel issues IMMA")


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


def compare_call(torch, build, policy, name, label, run, ops, nbytes,
                 lib_ms=None, kind="int8", tol=None, control=None) -> tuple:
    """Kernel vs plain version on the same inputs, then timed: exact, or
    with ``tol`` max|kernel - plain| <= tol * max|plain|, while the plain
    version of the neighbouring schedule (``control()``) misses ``tol``.
    Returns (max_abs_err, kernel ms, plain ms)."""
    got = run()
    with build.plain_versions():
        want = run()
        other = None if control is None else control()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    nan = bool(torch.isnan(got).any() or torch.isnan(want).any())
    peak = max(float(want.abs().max()), 1e-30)
    rel = err / peak
    ok = torch.equal(got, want) if tol is None else rel <= tol
    gap = None
    if other is not None:
        gap = float((other - want).abs().max()) / peak
        log(f"[compare] {name} {label}: the neighbouring schedule's plain "
            f"version is {gap:.3e} away (must exceed {tol})")
        ok = ok and gap > tol
    ms = cuda_ms(run, iters=10)
    with build.plain_versions():
        plain_ms = cuda_ms(run, iters=3, warmup=1)
    b_ms, b_by = bound_ms(ops, nbytes, kind)
    log(f"[compare] {policy:16s} {name:21s} {label:7s} "
        f"shape={tuple(got.shape)} max_abs_err={err} max_rel={rel:.3e} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
        f"bound_ms={b_ms:.5f} ({b_by}, {kind})")
    if nan or not ok:
        raise SystemExit(f"{name}/{label}/{policy}: kernel != plain "
                         f"(max_abs_err={err}, max_rel={rel}, tol={tol}, "
                         f"neighbour gap={gap}, nan={nan})")
    return err, ms, plain_ms


def add_summary(summary, name, err, ms, plain_ms, ops, nbytes, lib_ms,
                has_library, kind="int8"):
    s = summary.setdefault(name, {
        "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
        "library_ms": 0.0 if has_library else None,
        "max_abs_err": 0.0, "ops": 0.0, "bytes": 0.0, "kind": kind})
    s["ms"] += ms
    s["plain_ms"] += plain_ms
    s["ops"] += ops
    s["bytes"] += nbytes
    s["max_abs_err"] = max(s["max_abs_err"], err)
    if s["library_ms"] is not None:
        s["library_ms"] = None if lib_ms is None else s["library_ms"] + lib_ms


def phase_compare(torch) -> dict:
    from repro_torch.core.substrate import INT_POLICY_SPECS
    from repro_torch.kernels import build

    gen = torch.Generator().manual_seed(0)
    summary = {}
    for policy in POLICIES:
        variant, bb = INT_POLICY_SPECS[policy]
        for name, label, run, ops, nbytes, args in alexnet_calls(
                torch, policy, gen, torch.device("cuda")):
            lib_ms = None
            if name == "kom_matmul":
                lib_ms = int_mm_passes_ms(torch, args[0], args[1], variant,
                                          bb)
            err, ms, plain_ms = compare_call(torch, build, policy, name,
                                             label, run, ops, nbytes, lib_ms)
            if policy == "kom_int14":
                add_summary(summary, name, err, ms, plain_ms, ops, nbytes,
                            lib_ms, name == "kom_matmul")
    log("[compare] the implicit and Winograd convs have no single PyTorch "
        "call computing the same quantized limb arithmetic: library_ms null")
    for s in summary.values():
        s["bound_ms"], s["bound_by"] = bound_ms(s["ops"], s["bytes"],
                                                s["kind"])
    return summary


# ---------------------------------------------------------------------------
# Phase 4: the pooled and handoff variants, VGG16 and AlexNet shapes.
# ---------------------------------------------------------------------------

def fused_calls(torch, policy: str, gen, dev) -> list:
    """One (kernel, label, run, ops, bytes) per pooled / handoff call:
    VGG16's producers and consumers at batch 8 (one forward at the largest
    serving bucket), AlexNet conv2 (pooled) and conv3 (handoff) at batch
    16.  Inputs are made the way the serving path makes them: ReLU'd
    activations, the layer's own activation scales, and handoff inputs
    from ``handoff_quantize``."""
    import torch.nn.functional as F

    from repro_torch.core.substrate import INT_POLICY_SPECS, kom_qmax
    from repro_torch.kernels.conv2d.implicit_gemm import (
        conv2d_implicit_handoff_raw, conv2d_implicit_raw)
    from repro_torch.kernels.conv2d.ops import handoff_quantize, patch_scales
    from repro_torch.kernels.conv2d.winograd import (
        channel_absmax, tile_scales_from_cmax, tile_scales_upsampled)

    variant, bb = INT_POLICY_SPECS[policy]
    passes = 3 if variant == "karatsuba" else 4
    qmax = kom_qmax(bb)

    def ints(shape):
        return torch.randint(-qmax, qmax + 1, shape, generator=gen,
                             dtype=torch.int32).to(torch.int16).to(dev)

    def pos(shape):
        return (torch.rand(shape, generator=gen) * 1e-3 + 1e-4).to(dev)

    def act(shape):
        return torch.relu(torch.randn(shape, generator=gen)).to(dev)

    def pooled(label, n, h, k, cin, cout, pool=(2, 2)):
        x, wv = act((n, h, h, cin)), ints((k, k, cin, cout))
        p = k // 2
        cmax = F.pad(channel_absmax(x), (p, p, p, p))
        if k == 3:   # the shared tile-scale plan of 3x3/s1 layers
            asc = tile_scales_upsampled(
                tile_scales_from_cmax(cmax, qmax, -(-h // 2), -(-h // 2)),
                h, h)
        else:
            asc = patch_scales(cmax, k, k, 1, qmax)
        asc = asc.contiguous()
        ws, bias = pos((cout,)), torch.randn((cout,), generator=gen).to(dev)
        run = (lambda: conv2d_implicit_raw(
            x, wv, asc, ws, bias, stride=1, pads=(p, p), out_hw=(h, h),
            span_c=cin, variant=variant, base_bits=bb, pool=pool))
        ops = 2.0 * n * h * h * k * k * cin * cout * passes
        ho = h // 2 if pool else h
        nbytes = 4 * x.numel() + 2 * wv.numel() + 4 * asc.numel() \
            + 8 * cout + 4 * n * ho * ho * cout
        return ("implicit_conv_pool", label, run, ops, nbytes)

    def handoff(label, n, h, cin, cout):
        qa = handoff_quantize(act((n, h, h, cin)), base_bits=bb)
        wv = ints((3, 3, cin, cout))
        ws, bias = pos((cout,)), torch.randn((cout,), generator=gen).to(dev)
        run = (lambda: conv2d_implicit_handoff_raw(
            qa.values, qa.scale, wv, ws, bias, bk=cin, variant=variant,
            base_bits=bb))
        ops = 2.0 * n * h * h * 9 * cin * cout * passes
        nbytes = 2 * qa.values.numel() + 4 * qa.scale.numel() \
            + 2 * wv.numel() + 8 * cout + 4 * n * h * h * cout
        return ("implicit_conv_handoff", label, run, ops, nbytes)

    def plain(label, n, h, cin, cout):
        name, _, run, ops, nbytes = pooled(label, n, h, 3, cin, cout,
                                           pool=None)
        return ("implicit_conv", label, run, ops, nbytes)

    calls = [pooled(f"v{h}", VGG_BATCH, h, 3, cin, cout)
             for h, cin, cout in VGG16_POOLED]
    calls += [plain(f"v{h}", VGG_BATCH, h, cin, cout)
              for h, cin, cout in VGG16_PLAIN]
    calls += [handoff(f"v{h}", VGG_BATCH, h, cin, cout)
              for h, cin, cout in VGG16_HANDOFF]
    calls.append(pooled("a-conv2", BATCH, 27, 5, 96, 256))
    calls.append(handoff("a-conv3", BATCH, 13, 256, 384))
    return calls


def phase_compare_fused(torch) -> dict:
    """Phase 4; the summary sums one VGG16 forward's pooled and handoff
    calls (kom_int14); its three plain-epilogue calls are summed in a log
    line (the JSON row of ``implicit_conv`` stays AlexNet conv2's)."""
    from repro_torch.kernels import build

    gen = torch.Generator().manual_seed(2)
    summary, vgg_plain = {}, {}
    for policy in POLICIES:
        for name, label, run, ops, nbytes in fused_calls(
                torch, policy, gen, torch.device("cuda")):
            err, ms, plain_ms = compare_call(torch, build, policy, name,
                                             label, run, ops, nbytes)
            if name == "implicit_conv":   # row 4a's VGG16 part, logged
                if policy == "kom_int14":
                    add_summary(vgg_plain, name, err, ms, plain_ms, ops,
                                nbytes, None, False)
            elif policy == "kom_int14" and label.startswith("v"):
                add_summary(summary, name, err, ms, plain_ms, ops, nbytes,
                            None, False)
            elif name in summary:
                s = summary[name]
                s["max_abs_err"] = max(s["max_abs_err"], err)
    s = vgg_plain["implicit_conv"]
    b_ms, b_by = bound_ms(s["ops"], s["bytes"], s["kind"])
    log(f"[compare] implicit_conv (plain epilogue) over one VGG16 forward "
        f"({len(VGG16_PLAIN)} convs, batch {VGG_BATCH}, kom_int14): "
        f"kernel_ms={s['ms']:.4f} plain_ms={s['plain_ms']:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}, {100 * b_ms / s['ms']:.1f}%)")
    for name in ("implicit_conv_pool", "implicit_conv_handoff"):
        s = summary[name]
        b_ms, b_by = bound_ms(s["ops"], s["bytes"], s["kind"])
        log(f"[compare] {name} over one VGG16 forward (batch {VGG_BATCH}, "
            f"kom_int14): kernel_ms={s['ms']:.4f} plain_ms="
            f"{s['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}, "
            f"{100 * b_ms / s['ms']:.1f}%)")
    log("[compare] the pooled and handoff variants have no single PyTorch "
        "call computing the same quantized limb arithmetic: library_ms null")
    for s in summary.values():
        s["bound_ms"], s["bound_by"] = bound_ms(s["ops"], s["bytes"],
                                                s["kind"])
    return summary


# ---------------------------------------------------------------------------
# Phase 7: the systolic conv, the float implicit variants, the bf16 GEMM.
# ---------------------------------------------------------------------------

def _conv_library_ms(torch, x, w, bias, pad: int) -> float:
    """Yardstick: one fp32 ``F.conv2d`` (channels-last, TF32 off) for the
    same NHWC conv."""
    import torch.nn.functional as F
    xc = x.permute(0, 3, 1, 2)                       # channels-last view
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return cuda_ms(lambda: F.conv2d(xc, wc, bias, padding=pad), iters=10)


def systolic_float_calls(torch, gen, dev) -> list:
    """One (kernel, policy, label, run, ops, bytes, kind, tol, library ms,
    summed, control) per call: every full-width VGG16 conv geometry at
    batch 8 under the integer systolic engine (``karatsuba``,
    ``schoolbook``) and the float conv kernel (``native`` -- the systolic
    engine's native variant too -- ``bf16x3``, ``bf16x6``), AlexNet conv2
    (batch 16) on the integer systolic, and VGG16's three FC shapes (batch
    8) on the bf16-limb GEMM with passes 3, 4 and 6.  ``summed``: the call
    belongs to the JSON line's per-forward sums (kom_int14, bf16x3 GEMM);
    ``control``: the neighbouring schedule's call on the same inputs."""
    from repro_torch.core.karatsuba import schedule_dot
    from repro_torch.core.substrate import (INT_POLICY_SPECS, kom_qmax,
                                            quantize_symmetric)
    from repro_torch.kernels.conv2d.conv2d import conv2d_systolic_raw
    from repro_torch.kernels.conv2d.implicit_gemm import (
        conv2d_implicit_float_raw)
    from repro_torch.kernels.kom_matmul import bf16x3_matmul
    from repro_torch.models.cnn import ALEXNET, VGG16, cnn_conv_geometries

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    calls = []
    geoms = [(f"v{g['h']}-{g['cin']}", VGG_BATCH, g)
             for g in cnn_conv_geometries(VGG16)]
    alex2 = ("a-conv2", BATCH, cnn_conv_geometries(ALEXNET)[1])
    for label, n, g in geoms + [alex2]:
        h, k, cin, cout = g["h"], g["kh"], g["cin"], g["cout"]
        pad = k // 2
        macs = float(n * h * h * k * k * cin * cout)
        x = torch.relu(randn((n, h, h, cin)))
        w = randn((k, k, cin, cout), (k * k * cin) ** -0.5)
        bias = randn((cout,), 0.1)
        out_bytes = 4 * n * h * h * cout
        for policy in POLICIES:
            variant, bb = INT_POLICY_SPECS[policy]
            qmax = kom_qmax(bb)
            qx = quantize_symmetric(x, base_bits=bb, axis=0)
            xq = qx.values.to(torch.int16)
            wq = torch.randint(-qmax, qmax + 1, (k, k, cin, cout),
                               generator=gen, dtype=torch.int32).to(
                                   torch.int16).to(dev)
            scale = (qx.scale.reshape(n, 1)
                     * (torch.rand(cout, generator=gen) * 1e-4).to(dev))
            run = (lambda xq=xq, wq=wq, sc=scale, b=bias, v=variant, bb=bb,
                   h=h, pad=pad: conv2d_systolic_raw(
                       xq, wq, sc, b, stride=1, pads=(pad, pad),
                       out_hw=(h, h), variant=v, base_bits=bb))
            nbytes = 2 * (xq.numel() + wq.numel()) + 4 * (
                scale.numel() + cout) + out_bytes
            passes = 3 if variant == "karatsuba" else 4
            calls.append(("systolic_conv", policy, label, run,
                          2 * macs * passes, nbytes, "int8", None, None,
                          policy == "kom_int14" and label != alex2[0], None))
        if label == alex2[0]:
            continue
        lib_ms = _conv_library_ms(torch, x, w, bias, pad)
        nbytes = 4 * (x.numel() + w.numel() + cout) + out_bytes

        def run_for(v, x=x, w=w, b=bias, h=h, pad=pad):
            return lambda: conv2d_implicit_float_raw(
                x, w, b, stride=1, pads=(pad, pad), out_hw=(h, h), variant=v)
        for variant, passes in (("native", 1), ("bf16x3", 3),
                                ("bf16x6", 6)):
            calls.append((f"implicit_conv_{variant}",
                          "fp32" if variant == "native" else variant, label,
                          run_for(variant), 2 * macs * passes, nbytes,
                          "fp32" if variant == "native" else "bf16",
                          FLOAT_TOL, lib_ms, True,
                          run_for(NEIGHBOUR[variant])))
    for m in GEMM_ROWS:
        for label, (k, n) in VGG16_FC:
            a, b = torch.relu(randn((m, k))), randn((k, n), k ** -0.5)
            lib_ms = cuda_ms(lambda a=a, b=b: torch.matmul(a, b), iters=10)
            for passes in (3, 4, 6):
                run = (lambda a=a, b=b, p=passes:
                       bf16x3_matmul(a, b, passes=p))
                nb = {3: 1, 4: 3, 6: 3}[passes]  # native f32, bf16x3, bf16x3
                control = (lambda a=a, b=b, q=nb:
                           schedule_dot(a, b, passes=q).float())
                calls.append(("bf16_matmul", f"bf16x{passes}",
                              f"{label} m{m}", run,
                              2.0 * m * k * n * passes,
                              4 * (m * k + k * n + m * n), "bf16", FLOAT_TOL,
                              lib_ms, passes == 3 and m == VGG_BATCH,
                              control))
    return calls


def phase_compare_systolic_float(torch) -> dict:
    """Phase 7; the summary sums one VGG16 forward's calls: the integer
    systolic under kom_int14, the float convs, the bf16x3 GEMM.  The
    systolic engine's native variant runs the float conv kernel's native
    instantiation, so its row reports that kernel's numbers.  First the
    float conv library's tensor-core opcodes (the bf16 schedules must
    issue ``mma.sync``: HMMA) and the one-MMA rounding probe."""
    from repro_torch.analysis import mma_probe
    from repro_torch.kernels import build

    tc = {op: build.sass_count("implicit_conv_float", op)
          for op in ("HGMMA", "HMMA")}
    log(f"[compare] tensor-core instructions in the implicit_conv_float "
        f"library's SASS (cuobjdump -sass): {tc}")
    if not tc["HMMA"]:
        raise SystemExit("[compare] the bf16 float convs issue no mma.sync")
    for case, r in mma_probe.run().items():
        log(f"[compare] one bf16 MMA, {case}, vs the exact sum: "
            f"{r['outputs']} outputs, max error {r['max_err_grid']} units of "
            f"the top addend's f32 grid, toward zero {r['toward_zero']:.4f}, "
            f"bitwise equal to " + ", ".join(
                f"{k} {v:.4f}" for k, v in r["bitwise"].items()))
        if r["max_err_grid"] > 17:
            raise SystemExit(f"[compare] MMA probe {case}: error beyond the "
                             f"emulated model's bound: {r}")

    gen = torch.Generator().manual_seed(3)
    summary, schoolbook_ms, gemm = {}, 0.0, {}
    for (name, policy, label, run, ops, nbytes, kind, tol, lib_ms,
         summed, control) in systolic_float_calls(torch, gen,
                                                  torch.device("cuda")):
        err, ms, plain_ms = compare_call(torch, build, policy, name, label,
                                         run, ops, nbytes, lib_ms, kind, tol,
                                         control)
        if name == "bf16_matmul":
            t = gemm.setdefault((policy, label.split(" m")[1]),
                                [0.0, 0.0, 0.0])
            t[0] += ms
            t[1] += lib_ms
            t[2] += bound_ms(ops, nbytes, kind)[0]
        if summed:
            add_summary(summary, name, err, ms, plain_ms, ops, nbytes,
                        lib_ms, lib_ms is not None, kind)
        else:
            s = summary.get(name)
            if s is not None:
                s["max_abs_err"] = max(s["max_abs_err"], err)
            if policy == "schoolbook_int16" and label.startswith("v"):
                schoolbook_ms += ms
    for (policy, m), (ms, lib_ms, b_ms) in gemm.items():
        log(f"[compare] bf16_matmul {policy} m={m} over fc6+fc7+fc8: "
            f"kernel_ms={ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f}")
    for variant in ("native", "bf16x3", "bf16x6"):
        s = summary[f"implicit_conv_{variant}"]
        b_ms, b_by = bound_ms(s["ops"], s["bytes"], s["kind"])
        log(f"[compare] implicit_conv_{variant} over one VGG16 forward (13 "
            f"convs, batch {VGG_BATCH}): kernel_ms={s['ms']:.4f} "
            f"library_ms={s['library_ms']:.4f} (F.conv2d fp32) "
            f"bound_ms={b_ms:.4f} ({b_by}, {s['kind']}, "
            f"{100 * b_ms / s['ms']:.1f}%)")
    log(f"[compare] systolic_conv schoolbook_int16: {schoolbook_ms:.4f} ms "
        "over the VGG16 geometries; the integer systolic conv has no single "
        "PyTorch call computing the same quantized limb arithmetic: "
        "library_ms null")
    for s in summary.values():
        s["bound_ms"], s["bound_by"] = bound_ms(s["ops"], s["bytes"],
                                                s["kind"])
    summary["systolic_conv_native"] = dict(summary["implicit_conv_native"])
    return summary


# ---------------------------------------------------------------------------
# Phase 5: serve full-width AlexNet through the kernels.
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


# ---------------------------------------------------------------------------
# Phase 6: serve full-width VGG16 through the fused plan.
# ---------------------------------------------------------------------------

def phase_serve_vgg16(torch, card: str) -> dict:
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.planner import explore
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.models.cnn import (cnn_forward, cnn_init,
                                        cnn_quantize_params)
    from repro_torch.serving.cnn_engine import (CNNServeEngine, ImageRequest,
                                                params_to)

    cfg = get_config("vgg16", policy=MatmulPolicy.KOM_INT14)
    plan = explore(cfg, model_only=True, requant=True, backend="cuda")
    fusions = [e.fusion for e in plan.entries]
    log("[vgg16] plan: " + ", ".join(f"{e.key} {e.path}/{e.fusion}"
                                     for e in plan.entries))
    if "pool" not in fusions or "pool_quant" not in fusions:
        raise SystemExit(f"the requant plan fused nothing: {fusions}")
    gen = torch.Generator().manual_seed(0)
    params = random_biases(torch, cnn_init(cfg, gen, device="cuda"), gen)
    eng = CNNServeEngine(cfg, params, buckets=(1, 4, 8), device="cuda",
                         plan=plan)
    t0 = time.perf_counter()
    eng.warmup()
    log(f"[vgg16] warmup {time.perf_counter() - t0:.2f}s "
        f"(buckets {eng.buckets})")
    rng = np.random.default_rng(0)
    n_req = 16
    imgs = rng.standard_normal((n_req, 224, 224, 3)).astype(np.float32)
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
    want = {"kom_matmul": 4 * forwards, "implicit_conv_pool": 5 * forwards,
            "implicit_conv_handoff": 4 * forwards,
            "implicit_conv": 3 * forwards}
    log(f"[vgg16] {forwards} forwards, launches {launches}, "
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
        raise SystemExit(f"VGG16 engine logits != plain forward on the card "
                         f"(max diff {np.abs(plain - logits).max()})")
    log("[vgg16] engine logits == plain-version forward on the card, "
        "bitwise")
    fp32 = cfg.replace(policy=MatmulPolicy.FP32)
    with torch.inference_mode():
        ref = cnn_forward(params, fp32, x_all[:2]).cpu().numpy()
    rel = float(np.abs(logits[:2] - ref).max() / np.abs(ref).max())
    top1 = float(np.mean(logits[:2].argmax(1) == ref.argmax(1)))
    log(f"[vgg16] kom_int14 (fused plan) vs fp32 logits: max rel err "
        f"{rel:.3e}, top-1 agreement {top1}")
    if not rel < 0.1:
        raise SystemExit(f"kom_int14 VGG16 logits far from fp32 ({rel})")
    # Small input: the fused plan's kernels on the card == CPU plain versions.
    rcfg = reduced(cfg)
    rplan = explore(rcfg, model_only=True, requant=True, backend="cpu")
    gen = torch.Generator().manual_seed(1)
    rp = cnn_quantize_params(
        random_biases(torch, cnn_init(rcfg, gen, device="cpu"), gen), rcfg)
    xs = torch.from_numpy(rng.standard_normal(
        (2, rcfg.img_size, rcfg.img_size, 3)).astype(np.float32))
    with torch.inference_mode():
        cpu_out = cnn_forward(rp, rcfg, xs, plan=rplan).numpy()
        gpu_out = cnn_forward(
            params_to(rp, "cuda"), rcfg, xs.cuda(),
            plan=dataclasses.replace(rplan, backend="cuda")).cpu().numpy()
    if not np.array_equal(cpu_out, gpu_out):
        raise SystemExit("reduced VGG16 (fused plan): card kernels != CPU "
                         "plain versions (max diff "
                         f"{np.abs(cpu_out - gpu_out).max()})")
    log("[vgg16] reduced VGG16, fused plan: kernels on the card == plain "
        "versions on the CPU, bitwise")
    phase_profile(torch, eng, imgs[:VGG_BATCH])
    s = eng.stats()
    log(f"[vgg16] vgg16/kom_int14 on {card}: {s['images_done']} images, "
        f"{s['images_per_s']:.1f} img/s batched, {n_req / wall:.1f} img/s "
        f"wall, p50 latency {1e3 * s['latency_p50_s']:.2f} ms, "
        f"p95 latency {1e3 * s['latency_p95_s']:.2f} ms, "
        f"buckets {s['bucket_counts']}")
    return launches


# ---------------------------------------------------------------------------
# Phases 8-9: full-width VGG16 on the systolic engine and under bf16x3.
# ---------------------------------------------------------------------------

def serve_burst(torch, eng, imgs, tag: str) -> tuple:
    """Warm the engine up, then serve ``imgs`` as one burst with the
    launch counters reset just before.  Returns (logits, launches,
    forwards, wall seconds)."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.serving.cnn_engine import ImageRequest

    t0 = time.perf_counter()
    eng.warmup()
    log(f"[{tag}] warmup {time.perf_counter() - t0:.2f}s "
        f"(buckets {eng.buckets})")
    steps0 = eng.batcher.steps
    build.reset_launches()
    t0 = time.perf_counter()
    for uid in range(len(imgs)):
        eng.submit(ImageRequest(uid=uid, image=imgs[uid]))
    done = eng.run()
    wall = time.perf_counter() - t0
    launches = build.launch_counts()
    forwards = eng.batcher.steps - steps0
    if sorted(done) != list(range(len(imgs))):
        raise SystemExit(f"[{tag}] served {len(done)} of {len(imgs)}")
    logits = np.stack([done[u].logits for u in range(len(imgs))])
    if logits.shape != (len(imgs), eng.cfg.n_classes) \
            or not np.isfinite(logits).all():
        raise SystemExit(f"[{tag}] bad logits: shape {logits.shape}")
    return logits, launches, forwards, wall


def check_launches(tag, launches, want) -> None:
    log(f"[{tag}] launches {launches}, expected {want}")
    if launches != want:
        raise SystemExit(f"[{tag}] launch counts {launches} != {want}")


def log_stats(tag, eng, n_req, wall, card) -> None:
    s = eng.stats()
    log(f"[{tag}] {eng.cfg.name}/{eng.cfg.policy.value}/{eng.cfg.conv_path} "
        f"on {card}: {s['images_done']} images, "
        f"{s['images_per_s']:.1f} img/s batched, {n_req / wall:.1f} img/s "
        f"wall, p50 latency {1e3 * s['latency_p50_s']:.2f} ms, "
        f"p95 latency {1e3 * s['latency_p95_s']:.2f} ms, "
        f"buckets {s['bucket_counts']}")


def reduced_card_vs_cpu(torch, arch, policy, path, tol, tag,
                        control=None) -> None:
    """A reduced model with every conv on ``path``: the kernels on the card
    against the plain versions on the CPU (bitwise when ``tol`` is None);
    the CPU forward under the ``control`` policy (implicit) must miss
    ``tol``."""
    import numpy as np

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.models.cnn import (cnn_forward, cnn_init,
                                        cnn_quantize_params)
    from repro_torch.serving.cnn_engine import params_to

    cfg = reduced(get_config(arch, policy=MatmulPolicy(policy),
                             conv_path=path))
    gen = torch.Generator().manual_seed(1)
    rp = cnn_quantize_params(
        random_biases(torch, cnn_init(cfg, gen, device="cpu"), gen), cfg)
    xs = torch.randn((2, cfg.img_size, cfg.img_size, 3), generator=gen)
    with torch.inference_mode():
        cpu_out = cnn_forward(rp, cfg, xs).numpy()
        gpu_out = cnn_forward(params_to(rp, "cuda"), cfg,
                              xs.cuda()).cpu().numpy()
        other = None if control is None else cnn_forward(rp, cfg.replace(
            policy=MatmulPolicy(control), conv_path="implicit"), xs).numpy()
    peak = float(np.abs(cpu_out).max())
    rel = float(np.abs(cpu_out - gpu_out).max()) / peak
    ok = np.array_equal(cpu_out, gpu_out) if tol is None else rel <= tol
    note = ""
    if other is not None:
        gap = float(np.abs(other - cpu_out).max()) / peak
        note = f"; the CPU's {control} logits are {gap:.3e} away"
        ok = ok and gap > tol
    log(f"[{tag}] reduced {arch} {policy}/{path}: card vs CPU max rel err "
        f"{rel:.3e} ({'bitwise' if tol is None else f'tolerance {tol}'})"
        f"{note}")
    if not ok:
        raise SystemExit(f"reduced {arch} {policy}/{path}: card kernels != "
                         f"CPU plain versions (max rel err {rel})")


def vgg16_params(torch) -> list:
    """Full-width VGG16 float params on the card (seed 0, random biases),
    shared by the kom_int14, fp32 and bf16x3 runs."""
    from repro_torch.configs import get_config
    from repro_torch.models.cnn import cnn_init

    gen = torch.Generator().manual_seed(0)
    return random_biases(torch, cnn_init(get_config("vgg16"), gen,
                                         device="cuda"), gen)


def phase_serve_vgg16_systolic(torch, card: str, params) -> tuple:
    """Phase 8.  Returns (launches of the serving run and of the fp32
    forward, the fp32 logits of the first 4 images, those images)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.models.cnn import cnn_forward
    from repro_torch.serving.cnn_engine import CNNServeEngine

    tag = "systolic"
    cfg = get_config("vgg16", policy=MatmulPolicy.KOM_INT14,
                     conv_path="systolic")
    eng = CNNServeEngine(cfg, params, buckets=(1, 4, 8), device="cuda")
    n_req = 16
    imgs = np.random.default_rng(0).standard_normal(
        (n_req, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    logits, launches, forwards, wall = serve_burst(torch, eng, imgs, tag)
    check_launches(tag, launches, {"systolic_conv": 13 * forwards,
                                   "kom_matmul": 3 * forwards})
    x_all = torch.from_numpy(imgs).cuda()
    with build.plain_versions():
        plain = eng.forward(x_all).cpu().numpy()
    if not np.array_equal(plain, logits):
        raise SystemExit("systolic VGG16 logits != plain forward on the "
                         f"card (max diff {np.abs(plain - logits).max()})")
    alone = eng.forward(x_all[:1]).cpu().numpy()
    if not np.array_equal(alone[0], logits[0]):
        raise SystemExit("systolic VGG16: a request served alone != the "
                         "same request in an 8-image step")
    log(f"[{tag}] engine logits == plain-version forward on the card, and "
        "== the image served alone, bitwise")
    for arch in ("vgg16", "alexnet"):
        reduced_card_vs_cpu(torch, arch, "kom_int14", "systolic", None, tag)
    phase_profile(torch, eng, imgs[:VGG_BATCH])
    log_stats(tag, eng, n_req, wall, card)
    # The accuracy yardstick: fp32 on the same engine, native variant.
    fp32 = cfg.replace(policy=MatmulPolicy.FP32)
    build.reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cnn_forward(params, fp32, x_all[:4])
        torch.cuda.synchronize()
    fp32_s = time.perf_counter() - t0
    ref = ref.cpu().numpy()
    fp32_launches = build.launch_counts()
    check_launches(tag, fp32_launches, {"systolic_conv_native": 13})
    rel = float(np.abs(logits[:4] - ref).max() / np.abs(ref).max())
    top1 = float(np.mean(logits[:4].argmax(1) == ref.argmax(1)))
    log(f"[{tag}] fp32 systolic forward of 4 images {1e3 * fp32_s:.2f} ms; "
        f"kom_int14 vs fp32 logits: max rel err {rel:.3e}, top-1 agreement "
        f"{top1}")
    if not (np.isfinite(ref).all() and rel < 1e-2):
        raise SystemExit(f"kom_int14 systolic logits too far from fp32 "
                         f"({rel})")
    for k, v in fp32_launches.items():
        launches[k] = launches.get(k, 0) + v
    return launches, ref, imgs[:4]


def phase_serve_vgg16_bf16x3(torch, card: str, params, ref, ref_imgs
                             ) -> dict:
    """Phase 9: VGG16 under bf16x3 on the implicit engine."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.serving.cnn_engine import CNNServeEngine

    tag = "bf16x3"
    cfg = get_config("vgg16", policy=MatmulPolicy.BF16X3,
                     conv_path="implicit")
    eng = CNNServeEngine(cfg, params, buckets=(1, 4, 8), device="cuda")
    n_req = 16
    imgs = np.random.default_rng(0).standard_normal(
        (n_req, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    if not np.array_equal(imgs[:4], ref_imgs):
        raise SystemExit("the fp32 yardstick saw other images")
    logits, launches, forwards, wall = serve_burst(torch, eng, imgs, tag)
    check_launches(tag, launches, {"implicit_conv_bf16x3": 13 * forwards,
                                   "bf16_matmul": 3 * forwards})
    x_all = torch.from_numpy(imgs).cuda()
    with build.plain_versions():
        plain = eng.forward(x_all).cpu().numpy()
    rel_plain = float(np.abs(plain - logits).max() / np.abs(plain).max())
    rel_fp32 = float(np.abs(logits[:4] - ref).max() / np.abs(ref).max())
    top1 = float(np.mean(logits[:4].argmax(1) == ref.argmax(1)))
    log(f"[{tag}] engine vs plain-version forward on the card: max rel err "
        f"{rel_plain:.3e} (tolerance {FORWARD_TOL_BF16X3}); bf16x3 vs fp32 "
        f"logits: max rel err {rel_fp32:.3e} (limit 1e-3), top-1 agreement "
        f"{top1}")
    if not rel_plain <= FORWARD_TOL_BF16X3:
        raise SystemExit(f"bf16x3 VGG16 logits != plain forward ({rel_plain})")
    if not rel_fp32 <= 1e-3:
        raise SystemExit(f"bf16x3 VGG16 logits too far from fp32 ({rel_fp32})")
    reduced_card_vs_cpu(torch, "vgg16", "bf16x3", "implicit",
                        FORWARD_TOL_BF16X3, tag)
    for policy in ("bf16x6", "fp32"):
        reduced_card_vs_cpu(torch, "vgg16", policy, "implicit", FLOAT_TOL,
                            tag, control="bf16x3")
    phase_profile(torch, eng, imgs[:VGG_BATCH])
    log_stats(tag, eng, n_req, wall, card)
    return launches


def phase_profile(torch, eng, batch) -> None:
    """Where one serving step (host batch in, host logits out) spends its
    time (:func:`profile_step`)."""
    eng.run_batch(batch)
    profile_step(torch, lambda: eng.run_batch(batch),
                 f"one {len(batch)}-image step")


def profile_step(torch, fn, what: str, ranges=None) -> None:
    """Where one call of ``fn`` (which must end in a host sync) spends its
    time: its wall clock, and from ``torch.profiler`` the device time of
    every kernel and copy by name; device busy = the union of their
    intervals on the device timeline, idle = the profiled call's wall clock
    minus busy (an upper bound: the profiler slows the host).

    ``ranges`` (optional): ``(labels, context manager)`` -- the profiled
    call runs inside the context, which marks code with
    ``record_function(label)``; for each label the device busy time of the
    kernels inside its ranges on the device timeline is reported too."""
    import bisect
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    labels, ctx = ranges if ranges is not None else ((), None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            (ctx if ctx is not None else contextlib.nullcontext()):
        t0 = time.perf_counter()
        fn()
        prof_wall_ms = 1e3 * (time.perf_counter() - t0)
    spans, by_name, windows = [], {}, {lb: [] for lb in labels}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0_us, t1_us = e.time_range.start, e.time_range.end
        if e.name in windows:     # a range's span on the device timeline
            windows[e.name].append((t0_us, t1_us))
            continue
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
    log(f"[profile] {what}: wall {wall_ms:.3f} ms "
        f"({prof_wall_ms:.3f} ms profiled), device busy {busy:.3f} ms, "
        f"idle {100 * (1 - busy / prof_wall_ms):.1f}% of the profiled call")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :14]:
        log(f"[profile]   {us / 1e3:9.4f} ms  x{n:<3d} {name[:100]}")
    for label, wins in windows.items():
        if not wins:
            log(f"[profile]   {label}: not measured (no device range)")
            continue
        wins.sort()
        starts = [w[0] for w in wins]
        inside = 0.0
        for t0_us, t1_us in spans:
            i = bisect.bisect_right(starts, t0_us) - 1
            if i >= 0 and t0_us < wins[i][1]:
                inside += t1_us - t0_us
        span = sum(w[1] - w[0] for w in wins)
        log(f"[profile]   {label}: kernels {inside / 1e3:.3f} ms "
            f"({100 * inside / busy_us:.1f}% of device busy) over "
            f"{len(wins)} ranges spanning {span / 1e3:.3f} ms of the "
            "device timeline")


# ---------------------------------------------------------------------------
# Phases 10-13: the attention kernels and full-width granite-3-2b.
# ---------------------------------------------------------------------------

FA_MOD = "repro_torch.kernels.flash_attention.flash_attention"
FD_MOD = "repro_torch.kernels.flash_decode.flash_decode"


class mutated:
    """``module.name`` replaced by ``make(original)`` inside the block (the
    mutant controls: a plain version with its mask changed)."""

    def __init__(self, module: str, name: str, make):
        import importlib
        self.mod, self.name, self.make = (importlib.import_module(module),
                                          name, make)

    def __enter__(self):
        self.orig = getattr(self.mod, self.name)
        setattr(self.mod, self.name, self.make(self.orig))

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def strict_causal(orig):
    """Causal ``>`` for ``>=``: the diagonal key masked."""
    def live(q_pos, k_pos, *, causal, window):
        m = orig(q_pos, k_pos, causal=causal, window=window)
        return m & (q_pos[:, None] != k_pos[None, :]) if causal else m
    return live


def before_pos(orig):
    """Decode ``<`` for ``<=``: the key at ``pos`` masked."""
    return lambda k_pos, pos: k_pos < pos


def sdpa_ms(torch, q, k, v, mask, graph=False) -> float:
    """Yardstick: one ``F.scaled_dot_product_attention`` call with the same
    boolean mask (True = attend), GQA by ``enable_gqa``; never called by
    the port.  ``graph``: timed replayed from a CUDA graph."""
    import torch.nn.functional as F

    timed = ((lambda fn: cuda_graph_ms(fn, iters=20)) if graph
             else (lambda fn: cuda_ms(fn, iters=10)))
    try:
        return timed(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True))
    except (TypeError, RuntimeError) as e:  # no GQA in this build/backend
        log(f"  sdpa without enable_gqa ({e}): K/V repeated first")
        g = q.shape[1] // k.shape[1]
        k, v = (t.repeat_interleave(g, dim=1) for t in (k, v))
        return timed(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))


def attention_case(torch, build, summary, label, q, k, v, *, causal=True,
                   window=None, q_offset=0, row=False) -> None:
    """The flash-attention kernel against its plain version on the card:
    f32 within ATTN_TOL_F32, bf16 within ATTN_TOL_BF16, the strict-causal
    mutant required to miss the tolerance (f32; bf16 at q_offset 0); timed
    beside SDPA and the roofline (bf16 inputs at the bf16 peak)."""
    from repro_torch.analysis.roofline import attention_roofline
    from repro_torch.kernels.flash_attention import flash_attention

    run = lambda: flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    got = run()
    with build.plain_versions():
        want = run()
    f32 = q.dtype == torch.float32
    tol = ATTN_TOL_F32 if f32 else ATTN_TOL_BF16
    err = float((got.float() - want.float()).abs().max())
    miss = None
    if causal and (f32 or q_offset == 0):  # bf16: only where row 0 is short
        with mutated(FA_MOD, "live_mask", strict_causal), \
                build.plain_versions():
            miss = float((got.float() - run().float()).abs().max())
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = (pos >= kp) if causal else torch.ones_like(pos >= kp)
    if window is not None:
        mask &= (pos - kp) < window
    ms = cuda_ms(run, iters=10)
    with build.plain_versions():
        plain_ms = cuda_ms(run, iters=3, warmup=1)
    lib_ms = sdpa_ms(torch, q, k, v, mask)
    rf = attention_roofline(b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, dh=dh,
                            causal=causal, window=window, q_offset=q_offset,
                            itemsize=q.element_size())
    b_ms, b_by = bound_ms(rf["flops"], rf["bytes"], rf["kind"])
    log(f"[attention] flash_attention {label} {str(q.dtype)[6:]}: "
        f"max_abs_err={err} (tol {tol}) mutant_err={miss} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}, {rf['kind']}, "
        f"{100 * b_ms / ms:.1f}%)")
    if not (err <= tol and torch.isfinite(got.float()).all()) or \
            (miss is not None and not miss > tol):
        raise SystemExit(f"flash_attention {label}: kernel vs plain "
                         f"{err} (tol {tol}), mutant {miss}")
    if row:
        summary["flash_attention"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}


def decode_case(torch, build, summary, label, q, k, v, pos, row=False):
    """The flash-decode kernel against its plain version on the card (same
    tolerances; the ``<`` mutant must miss for f32, and for bf16 at a pos
    small enough that the dropped key moves the output past
    ATTN_TOL_BF16)."""
    from repro_torch.analysis.roofline import decode_attention_roofline
    from repro_torch.kernels.flash_decode import flash_decode

    run = lambda: flash_decode(q, k, v, pos)
    got = run()
    with build.plain_versions():
        want = run()
    f32 = q.dtype == torch.float32
    tol = ATTN_TOL_F32 if f32 else ATTN_TOL_BF16
    err = float((got.float() - want.float()).abs().max())
    miss = None
    if pos >= 0 and (f32 or pos < 8):  # pos < 0: every key is masked
        with mutated(FD_MOD, "valid_keys", before_pos), \
                build.plain_versions():
            miss = float((got.float() - run().float()).abs().max())
    b, hq, _, dh = q.shape
    hkv, S = k.shape[1], k.shape[2]
    eager_ms = cuda_ms(run, iters=10)
    with build.plain_versions():
        plain_ms = cuda_ms(run, iters=3, warmup=1)
    mask = (torch.arange(S, device=q.device) <= pos)[None, :]
    eager_lib_ms = sdpa_ms(torch, q, k, v, mask)
    # A decode call is shorter than its own Python dispatch: the kernel and
    # SDPA are also timed replayed from a CUDA graph (device time alone),
    # and those times are the row's.
    ms = cuda_graph_ms(run, iters=20)
    lib_ms = sdpa_ms(torch, q, k, v, mask, graph=True)
    rf = decode_attention_roofline(b=b, hq=hq, hkv=hkv, S=S, dh=dh, pos=pos,
                                   itemsize=q.element_size())
    b_ms, b_by = bound_ms(rf["flops"], rf["bytes"], rf["kind"])
    log(f"[attention] flash_decode {label} {str(q.dtype)[6:]}: "
        f"max_abs_err={err} (tol {tol}) mutant_err={miss} "
        f"kernel_ms={ms:.4f} (eager {eager_ms:.4f}) plain_ms={plain_ms:.4f} "
        f"sdpa_ms={lib_ms:.4f} (eager {eager_lib_ms:.4f}) "
        f"bound_ms={b_ms:.4f} ({b_by}, {rf['kind']}, "
        f"{100 * b_ms / ms:.1f}%)")
    if not (err <= tol and torch.isfinite(got.float()).all()) or \
            (miss is not None and not miss > tol):
        raise SystemExit(f"flash_decode {label}: kernel vs plain {err} "
                         f"(tol {tol}), mutant {miss}")
    if row:
        summary["flash_decode"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}


def phase_compare_attention(torch) -> tuple:
    """Phase 10.  Returns (summary rows, launches of the decode op's own
    run: its entry point, called once per ``pos`` with the counts reset
    just before)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import flash_decode

    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    summary = {}
    tc = {op: build.sass_count("flash_attention", op)
          for op in ("HGMMA", "HMMA")}
    log(f"[attention] tensor-core instructions in the flash_attention "
        f"library's SASS (cuobjdump -sass): {tc}")
    if not tc["HGMMA"]:
        raise SystemExit("[attention] the bf16 kernel issues no wgmma")
    q, k, v = rnd(4, 32, 2048, 64), rnd(4, 8, 2048, 64), rnd(4, 8, 2048, 64)
    attention_case(torch, build, summary, "prefill 4x2048", q, k, v)
    attention_case(torch, build, summary, "prefill 4x2048",
                   *(t.bfloat16() for t in (q, k, v)), row=True)
    for qq, kk, vv in ((q, k, v), tuple(t.bfloat16() for t in (q, k, v))):
        attention_case(torch, build, summary, "sq256@1792", qq[:, :, -256:],
                       kk, vv, q_offset=1792)
        attention_case(torch, build, summary, "window512", qq, kk, vv,
                       window=512)
    attention_case(torch, build, summary, "padded 1000", q[:, :, :1000],
                   k[:, :, :1000], v[:, :, :1000])
    del q, k, v
    q, kc, vc = rnd(8, 32, 1, 64), rnd(8, 8, 4096, 64), rnd(8, 8, 4096, 64)
    for pos in (0, 1000):
        decode_case(torch, build, summary, f"S4096 pos{pos}", q, kc, vc, pos)
    decode_case(torch, build, summary, "S4096 pos4095", q, kc, vc, 4095,
                row=True)
    decode_case(torch, build, summary, "S4096 pos4095",
                *(t.bfloat16() for t in (q, kc, vc)), 4095)
    decode_case(torch, build, summary, "S4096 pos3 (mutant)",
                *(t.bfloat16() for t in (q, kc, vc)), 3)
    decode_case(torch, build, summary, "S4096 pos-1 (all masked)", q, kc,
                vc, -1)
    decode_case(torch, build, summary, "S4000 pos3999 (padded)", q,
                kc[:, :, :4000], vc[:, :, :4000], 3999)
    build.reset_launches()
    for pos in (0, 1000, 4095):
        out = flash_decode(q, kc, vc, pos)
    torch.cuda.synchronize()
    launches = build.launch_counts()
    log(f"[attention] the decode op's own run (pos 0, 1000, 4095): "
        f"launches {launches}, output {tuple(out.shape)}")
    if launches != {"flash_decode": 3}:
        raise SystemExit(f"flash_decode op launches {launches}")
    return summary, launches


#: granite-3-2b's projections (k, n) with their count per serve_step: q,
#: k, v, o, gate, up, down in each of 40 layers, then the tied head.
GRANITE_GEMMS = (("q", (2048, 2048), 40), ("k", (2048, 512), 40),
                 ("v", (2048, 512), 40), ("o", (2048, 2048), 40),
                 ("gate", (2048, 8192), 40), ("up", (2048, 8192), 40),
                 ("down", (8192, 2048), 40), ("head", (2048, 49408), 1))


#: The decode GEMM's rows: one slot, the served 4 slots, a full m16 tile.
DECODE_ROWS = (1, 4, 16)


def phase_compare_lm_gemm(torch) -> dict:
    """Phase 10b: the limb GEMM at granite-3-2b's decode shapes under
    kom_int14 at m = 1, 4 (the served slots) and 16: exact against its
    plain version, the K split of ``kom_split_k`` printed beside each
    shape, timed eagerly (the wrapper's Python dispatch included) and as
    device time replayed from a CUDA graph, beside its three int8 passes
    through ``torch._int_mm``; the per-serve_step totals weight each shape
    by its count.  Returns the m = 4 totals."""
    from repro_torch.core.substrate import kom_qmax
    from repro_torch.kernels import build
    from repro_torch.kernels.kom_matmul import kom_matmul_int, kom_split_k

    gen = torch.Generator().manual_seed(5)
    qmax = kom_qmax(7)
    served = None
    for m in DECODE_ROWS:
        tot = {"ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bound_ms": 0.0}
        for label, (k, n), count in GRANITE_GEMMS:
            a = torch.randint(-qmax, qmax + 1, (m, k), generator=gen).to(
                torch.int16).cuda()
            b = torch.randint(-qmax, qmax + 1, (k, n), generator=gen).to(
                torch.int16).cuda()
            rs = (torch.rand(m, generator=gen) * 1e-3 + 1e-4).cuda()
            cs = (torch.rand(n, generator=gen) * 1e-3 + 1e-4).cuda()
            run = lambda a=a, b=b, rs=rs, cs=cs: kom_matmul_int(
                a, b, variant="karatsuba", base_bits=7, row_scale=rs,
                col_scale=cs)
            ops = 2.0 * m * k * n * 3
            nbytes = 2 * (m * k + k * n) + 4 * (m + n + m * n)
            plan = kom_split_k(m, k, n)
            log(f"[compare] kom_matmul granite {label} m={m}: split "
                f"{plan['splits']} x {plan['group_k']} K entries, "
                f"{plan['m_tile']}-row tile, {plan['blocks']} blocks")
            lib_ms = int_mm_passes_ms(torch, a, b, "karatsuba", 7)
            err, ms, plain_ms = compare_call(
                torch, build, "kom_int14", "kom_matmul",
                f"granite {label} m{m}", run, ops, nbytes, lib_ms)
            graph_ms = cuda_graph_ms(run, iters=20)
            log(f"[compare] kom_matmul granite {label} m={m}: device time "
                f"from a CUDA graph {graph_ms:.4f} ms")
            b_ms, _ = bound_ms(ops, nbytes, "int8")
            for key, v in (("ms", ms), ("graph_ms", graph_ms),
                           ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bound_ms", b_ms)):
                tot[key] = None if v is None or tot[key] is None \
                    else tot[key] + count * v
        log(f"[compare] kom_matmul per granite serve_step (281 calls, m = "
            f"{m}): " + ", ".join(f"{k} {v if v is None else round(v, 4)}"
                                  for k, v in tot.items()))
        if m == 4:
            served = tot
    return served


def lm_params(torch, arch: str = "granite-3-2b"):
    """Full-width float params of ``arch`` on the card (seed 0)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"[{arch}] {n / 1e9:.3f} B params (f32) on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_prefill(torch, card: str, params) -> dict:
    """Phase 11: the prefill step with the flash kernel, batch 4 x 2048."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.launch.step_fns import make_prefill_step

    cfg = get_config("granite-3-2b", use_flash_kernel=True)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 2048)).astype(np.int64)).cuda()
    batch = {"tokens": tokens}
    step = make_prefill_step(cfg)
    step(params, batch)
    torch.cuda.synchronize()
    build.reset_launches()
    logits = step(params, batch)
    torch.cuda.synchronize()
    launches = build.launch_counts()
    check_launches("prefill", launches, {"flash_attention": cfg.n_layers})
    if logits.shape != (4, 2048, cfg.padded_vocab) or \
            not torch.isfinite(logits).all():
        raise SystemExit(f"[prefill] bad logits {tuple(logits.shape)}")
    del logits
    n_it = 3
    t0 = time.perf_counter()
    for _ in range(n_it):
        step(params, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_it
    log(f"[prefill] granite-3-2b/native_bf16 flash on {card}: "
        f"{1e3 * dt:.1f} ms per 4x2048 prefill, {4 * 2048 / dt:.0f} "
        "tokens/s")
    profile_step(torch, lambda: step(params, batch).sum().item(),
                 "one 4x2048 native_bf16 prefill step")
    f32 = cfg.replace(policy=MatmulPolicy.FP32, compute_dtype="float32")
    step32 = make_prefill_step(f32)
    got = step32(params, batch)
    with build.plain_versions():
        want = step32(params, batch)
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"[prefill] fp32 (TF32 off): flash kernel vs plain-version forward "
        f"max rel err {rel:.3e} (tol {PREFILL_TOL_FP32})")
    if not rel <= PREFILL_TOL_FP32:
        raise SystemExit(f"[prefill] fp32 logits off by {rel}")
    return launches


class _Recorder:
    """Wraps a ServeEngine to record each request's logits rows and each
    engine step's wall time."""

    def __init__(self, eng):
        self.rows, self.step_s, self.eng = {}, [], eng
        self._pending = []
        group, sample = eng._step_group, eng._sample

        def step_group(pos, slot_ids, tok, suspect=False):
            self._pending = list(slot_ids)
            return group(pos, slot_ids, tok, suspect)

        def sample_row(row, temperature):
            uid = eng.active[self._pending.pop(0)].uid
            self.rows.setdefault(uid, []).append(row.copy())
            return sample(row, temperature)

        eng._step_group, eng._sample = step_group, sample_row

    def run(self, torch):
        while self.eng.has_work():
            t0 = time.perf_counter()
            self.eng.step()
            torch.cuda.synchronize()
            self.step_s.append(time.perf_counter() - t0)
        return self.eng.done


def limb_gemms_per_step(cfg) -> int:
    """Limb-GEMM launches of one forward or serve_step under kom_int14:
    dense -- 7 projections per layer; xLSTM -- 6 prequantized projections
    plus ``w_if`` (``kom_q_dot``) per mLSTM, ``w_in`` and ``w_down`` per
    sLSTM; then the head."""
    if cfg.family == "ssm":
        n_m = cfg.xlstm_group.count("m") * cfg.n_xlstm_groups
        n_s = cfg.xlstm_group.count("s") * cfg.n_xlstm_groups
        return 7 * n_m + 2 * n_s + 1
    return 7 * cfg.n_layers + 1


def phase_serve_lm(torch, card: str, params, policy: str,
                   arch: str = "granite-3-2b") -> dict:
    """Phases 12 and 17: full-width ``arch`` through ServeEngine: slots 4,
    max_len 512, 8 requests by the launcher's prompt rule, max_new 12; two
    requests re-served alone must give the same greedy tokens."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.serving.engine import Request, ServeEngine

    tag = f"serve_lm {arch} {policy}"
    cfg = get_config(arch, policy=MatmulPolicy(policy))
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, slots=4, max_len=512, device="cuda")
    torch.cuda.synchronize()
    log(f"[{tag}] engine built in {time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(0)
    prompts = []
    for _ in range(8):
        plen = int(rng.integers(3, 9))
        prompts.append(rng.integers(0, cfg.vocab_size,
                                    (plen,)).astype(np.int32))
    rec = _Recorder(eng)
    build.reset_launches()
    n_decode = [0]
    decode = eng._decode

    def counted(*a):
        n_decode[0] += 1
        return decode(*a)
    eng._decode = counted
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=12))
    done = rec.run(torch)
    wall = time.perf_counter() - t0
    launches = build.launch_counts()
    if sorted(done) != list(range(8)) or \
            any(len(done[u].out_tokens) != 12 for u in done):
        raise SystemExit(f"[{tag}] served {len(done)} of 8")
    per_step = limb_gemms_per_step(cfg)
    want = {"kom_matmul": n_decode[0] * per_step} \
        if policy == "kom_int14" else {}
    check_launches(tag, launches, want)
    n_tok = sum(len(done[u].out_tokens) for u in done)
    st = np.array(rec.step_s)
    if policy == "kom_int14":
        log(f"[{tag}] {per_step} limb-GEMM launches per serve_step")
    log(f"[{tag}] {arch}/{policy} on {card}: 8/8 requests, {n_tok} "
        f"tokens in {wall:.2f}s ({n_tok / wall:.1f} decode tok/s), "
        f"{n_decode[0]} serve_steps, {len(st)} engine steps: p50 "
        f"{1e3 * np.percentile(st, 50):.2f} ms, p95 "
        f"{1e3 * np.percentile(st, 95):.2f} ms")
    batched = {u: list(done[u].out_tokens) for u in (0, 1)}
    rows = {u: np.stack(rec.rows[u]) for u in (0, 1)}
    for uid in (0, 1):
        eng.submit(Request(uid=100 + uid, prompt=prompts[uid],
                           max_new_tokens=12))
        rec.run(torch)
        solo = eng.done[100 + uid].out_tokens
        d = float(np.abs(np.stack(rec.rows[100 + uid]) - rows[uid]).max())
        log(f"[{tag}] req {uid} batched {batched[uid]} solo {solo}: "
            f"max |d logit| batched vs solo {d}")
        if solo != batched[uid]:
            raise SystemExit(f"[{tag}] req {uid}: batched greedy tokens != "
                             "solo")
    profile_step(torch, lambda: eng._decode(
        np.zeros((4, 1), np.int32), 100,
        eng._mask([0, 1, 2, 3]))[0].sum().item(),
        f"one {policy} decode step (4 slots)")
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_reduced_lm(torch, arch: str = "granite-3-2b") -> None:
    """Phases 13 and 18: reduced ``arch`` (granite: flash kernel on) under
    fp32 and kom_int14 (f32 compute, weights quantized once as the engine
    does): the forward and four decode steps on the card against the plain
    versions on the CPU (which the CPU tests hold against the JAX
    reference); for the xLSTM also kom_int14 on float weights (both
    operands quantized per tensor, ``kom_q_dot``) within FLOAT_WEIGHTS_TOL,
    with the card's ``base_bits=6`` forward required to miss it."""
    from repro_torch.analysis.kom_float_weights import (FLOAT_WEIGHTS_TOL,
                                                        base_bits)
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.models import transformer
    from repro_torch.serving.weight_quant import quantize_params_inline

    cases = [("fp32", REDUCED_TOL_FP32, False),
             ("kom_int14", REDUCED_TOL_KOM, False)]
    if arch == XLSTM:
        cases.append(("kom_int14", FLOAT_WEIGHTS_TOL, True))
    for policy, tol, float_weights in cases:
        cfg = reduced(get_config(arch)).replace(
            policy=MatmulPolicy(policy), compute_dtype="float32",
            use_flash_kernel=arch != XLSTM)
        params = transformer.init_params(
            cfg, torch.Generator().manual_seed(2), device="cpu")
        if policy == "kom_int14" and not float_weights:
            params = quantize_params_inline(params)
        gp = transformer.params_to(params, "cuda")
        tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                               generator=torch.Generator().manual_seed(3))
        want, _ = transformer.forward(params, cfg, {"tokens": tokens})
        build.reset_launches()
        got, _ = transformer.forward(gp, cfg, {"tokens": tokens.cuda()})
        launches = build.launch_counts()
        rel = float((got.cpu() - want).abs().max() / want.abs().max())
        cache = transformer.init_cache(cfg, 2, 8, device="cpu")
        gcache = transformer.init_cache(cfg, 2, 8, device="cuda")
        drel = 0.0
        for t in range(4):
            w, cache = transformer.serve_step(params, cfg, cache,
                                              tokens[:, t:t + 1], t)
            g, gcache = transformer.serve_step(gp, cfg, gcache,
                                               tokens[:, t:t + 1].cuda(), t)
            drel = max(drel, float((g.cpu() - w).abs().max()
                                   / w.abs().max()))
        what = policy + (" float weights" if float_weights else "")
        miss = None
        if float_weights:
            with base_bits(6):
                bad, _ = transformer.forward(gp, cfg,
                                             {"tokens": tokens.cuda()})
            miss = float((bad.cpu() - want).abs().max() / want.abs().max())
        log(f"[reduced_lm] {arch} (reduced) {what}: card vs CPU "
            f"forward {rel:.3e}, decode {drel:.3e} (tol {tol}), forward "
            f"launches {launches}"
            + ("" if miss is None else
               f"; base_bits=6 on the card {miss:.3e} away (must miss)"))
        want_l = {"flash_attention": cfg.n_layers} \
            if cfg.use_flash_kernel else {}
        if policy == "kom_int14":
            want_l["kom_matmul"] = limb_gemms_per_step(cfg)
        if launches != want_l or not (rel <= tol and drel <= tol) or \
                (miss is not None and not miss > tol):
            raise SystemExit(f"[reduced_lm] {what}: {rel}, {drel}, "
                             f"{launches}, control {miss}")

# ---------------------------------------------------------------------------
# Phases 14-18: the mLSTM kernel and full-width xlstm-125m.
# ---------------------------------------------------------------------------

SSM_MOD = "repro_torch.models.ssm"


def strict_causal_chunk(orig):
    """The intra-chunk mask without its diagonal (``>`` for ``>=``)."""
    def mask(chunk, device):
        return orig(chunk, device).tril(diagonal=-1)
    return mask


def no_input_gate(orig):
    """The state written without the input gate."""
    def weights(ltot, lcum, i_gate):
        return orig(ltot, lcum, i_gate.new_ones(i_gate.shape))
    return weights


#: The mutant plain versions the mLSTM kernel must miss: (name in
#: ``models.ssm``, its replacement).
MLSTM_MUTANTS = (("causal_mask", strict_causal_chunk),
                 ("state_write_weights", no_input_gate))


def mlstm_inputs(torch, b, h, s, dh, seed, *, strong=False, zero_ig=False):
    """tests/test_mlstm_kernel.py's distributions on the card; ``strong``:
    log_f about -5 (cumulative decays pass the -60 clip within a chunk);
    ``zero_ig``: every third input gate 0."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    q, k, v = rnd(b, h, s, dh), rnd(b, h, s, dh) * 0.3, rnd(b, h, s, dh)
    lf = torch.log(torch.rand((b, h, s), generator=gen, device="cuda")
                   * 0.29 + 0.7)
    if strong:
        lf = lf - 5.0
    ig = torch.rand((b, h, s), generator=gen, device="cuda") * 0.8 + 0.1
    if zero_ig:
        ig[:, :, ::3] = 0.0
    return q, k, v, lf, ig


def mlstm_case(torch, build, summary, label, q, k, v, lf, ig, *,
               chunk=64, row=False) -> None:
    """The mLSTM kernel against its plain version on the card: within
    MLSTM_TOL of max |plain| (f32 and bf16 inputs), the two mutant plain
    versions required to miss it (f32, more than one chunk); timed beside
    the roofline bound (no PyTorch call computes the chunkwise mLSTM)."""
    from repro_torch.analysis.roofline import mlstm_chunk_roofline
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk

    run = lambda: mlstm_chunk(q, k, v, lf, ig, chunk=chunk)
    got = run()
    with build.plain_versions():
        want = run()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    misses = []
    b, h, s, dh = q.shape
    if q.dtype == torch.float32 and s > chunk:
        for name, make in MLSTM_MUTANTS:
            with mutated(SSM_MOD, name, make), build.plain_versions():
                misses.append(float((got - run()).abs().max()) / scale)
    ms = cuda_ms(run, iters=10)
    with build.plain_versions():
        plain_ms = cuda_ms(run, iters=3, warmup=1)
    c = min(chunk, s)
    sp = s + (-s) % c
    rf = mlstm_chunk_roofline(b=b, h=h, s=sp, dh=dh, chunk=c,
                              itemsize=q.element_size())
    b_ms, b_by = bound_ms(rf["flops"], rf["bytes"], "fp32")
    split_ms, _ = bound_ms(rf["flops_dv_split"], rf["bytes"], "fp32")
    log(f"[mlstm] mlstm_chunk {label} {str(q.dtype)[6:]}: max_abs_err="
        f"{err} ({err / scale:.3e} of max|plain| {scale:.4g}, tol "
        f"{MLSTM_TOL}) mutants {['%.3e' % m for m in misses]} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=null "
        f"bound_ms={b_ms:.4f} ({b_by}, {100 * b_ms / ms:.1f}%; with the "
        f"dv split's recomputed scores {split_ms:.4f})")
    if not (err <= MLSTM_TOL * scale and torch.isfinite(got).all()) or \
            not all(m > MLSTM_TOL for m in misses):
        raise SystemExit(f"mlstm_chunk {label}: kernel vs plain {err} "
                         f"(tol {MLSTM_TOL} x {scale}), mutants {misses}")
    if row:
        summary["mlstm_chunk"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def phase_compare_mlstm(torch) -> tuple:
    """Phase 14.  Returns (summary row, launches of the op's own run: its
    entry point once at the layer shape, counts reset just before)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk

    summary = {}
    x = mlstm_inputs(torch, 4, 4, 2048, 384, 0)
    mlstm_case(torch, build, summary, "layer 4x4x2048 dh384", *x, row=True)
    mlstm_case(torch, build, summary, "layer 4x4x2048 dh384",
               *(t.bfloat16() for t in x[:3]), *x[3:])
    mlstm_case(torch, build, summary, "s2000 (padded)",
               *(t[:, :, :2000] for t in x))
    mlstm_case(torch, build, summary, "s17 (< chunk)",
               *(t[:, :, :17] for t in x))
    del x
    mlstm_case(torch, build, summary, "strong gates 2x4x2048",
               *mlstm_inputs(torch, 2, 4, 2048, 384, 1, strong=True))
    mlstm_case(torch, build, summary, "i_gate 0 rows 2x4x2048",
               *mlstm_inputs(torch, 2, 4, 2048, 384, 2, zero_ig=True))
    x = mlstm_inputs(torch, 1, 4, 32768, 384, 3)
    mlstm_case(torch, build, summary, "1x4x32768 (prefill_32k)", *x)
    del x
    x = mlstm_inputs(torch, 4, 4, 2048, 384, 0)
    build.reset_launches()
    out = mlstm_chunk(*x, chunk=64)
    torch.cuda.synchronize()
    launches = build.launch_counts()
    log(f"[mlstm] the op's own run (4x4x2048, dh 384): launches {launches}, "
        f"output {tuple(out.shape)}")
    if launches != {"mlstm_chunk": 1}:
        raise SystemExit(f"mlstm_chunk op launches {launches}")
    return summary, launches


class _capture_scan:
    """Inside the block, the first call of the model's chunk scan keeps its
    inputs and its y (the family's own tensors)."""

    def __init__(self):
        import importlib
        self.mod = importlib.import_module(SSM_MOD)
        self.got = None

    def __enter__(self):
        self.orig = self.mod._mlstm_chunk_scan

        def scan(q, k, v, log_f, i_gate, state, n_state, chunk):
            out = self.orig(q, k, v, log_f, i_gate, state, n_state, chunk)
            if self.got is None:
                self.got = (q, k, v, log_f, i_gate, chunk, out[0])
            return out
        self.mod._mlstm_chunk_scan = scan
        return self

    def __exit__(self, *exc):
        self.mod._mlstm_chunk_scan = self.orig


def phase_prefill_xlstm(torch, card: str, params) -> dict:
    """Phases 15-16: the prefill step on 4 x 2048 tokens under native_bf16
    (no kernel on this path: the model's chunk loop is plain PyTorch, as
    the reference's ``lax.scan``), the kernel on the first mLSTM layer's
    own q/k/v/gates against that layer's y, a profile, and one fp32
    forward (TF32 off)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    from repro_torch.launch.step_fns import make_prefill_step

    cfg = get_config(XLSTM)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 2048)).astype(np.int64)).cuda()
    batch = {"tokens": tokens}
    step = make_prefill_step(cfg)
    t_phase = time.perf_counter()
    with _capture_scan() as cap:
        step(params, batch)
    torch.cuda.synchronize()
    q, k, v, lf, ig, chunk, y = cap.got
    got = mlstm_chunk(q, k, v, lf, ig, chunk=chunk)
    scale = float(y.abs().max())
    err = float((got - y).abs().max())
    log(f"[xlstm] the kernel on the first mLSTM layer's own tensors "
        f"{tuple(q.shape)} chunk {chunk}: max_abs_err {err} "
        f"({err / scale:.3e} of max|y| {scale:.4g}, tol {MLSTM_TOL})")
    if not err <= MLSTM_TOL * scale:
        raise SystemExit(f"[xlstm] kernel vs mlstm_block's y: {err}")
    del cap, q, k, v, lf, ig, y, got
    build.reset_launches()
    logits = step(params, batch)
    torch.cuda.synchronize()
    launches = build.launch_counts()
    check_launches("xlstm prefill", launches, {})
    if logits.shape != (4, 2048, cfg.padded_vocab) or \
            not torch.isfinite(logits).all():
        raise SystemExit(f"[xlstm] bad logits {tuple(logits.shape)}")
    ref16 = logits
    n_it = 2
    t0 = time.perf_counter()
    for _ in range(n_it):
        step(params, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_it
    log(f"[xlstm] {XLSTM}/native_bf16 prefill on {card}: {1e3 * dt:.1f} ms "
        f"per 4x2048 prefill, {4 * 2048 / dt:.0f} tokens/s")
    profile_step(torch, lambda: step(params, batch).sum().item(),
                 "one 4x2048 native_bf16 prefill step",
                 ranges=(XLSTM_RANGES, _annotate_xlstm()))
    f32 = cfg.replace(policy=MatmulPolicy.FP32, compute_dtype="float32")
    step32 = make_prefill_step(f32)
    step32(params, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits32 = step32(params, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rel = float((ref16 - logits32).abs().max() / logits32.abs().max())
    log(f"[xlstm] {XLSTM}/fp32 prefill (TF32 off): {1e3 * dt:.1f} ms, "
        f"{4 * 2048 / dt:.0f} tokens/s; native_bf16 logits {rel:.3e} of "
        "max|logit| from the fp32 ones")
    if not torch.isfinite(logits32).all():
        raise SystemExit("[xlstm] fp32 logits not finite")
    log(f"[xlstm] prefill phases took {time.perf_counter() - t_phase:.1f}s")
    return launches


class _annotate_xlstm:
    """Inside the block, each mLSTM chunk loop and each sLSTM block runs
    under ``record_function`` (labels :data:`XLSTM_RANGES`)."""

    def __enter__(self):
        import importlib

        from torch.profiler import record_function

        def wrap(label, f):
            def wrapped(*a, **kw):
                with record_function(label):
                    return f(*a, **kw)
            return wrapped
        self.ssm = importlib.import_module(SSM_MOD)
        self.tr = importlib.import_module("repro_torch.models.transformer")
        self.saved = (self.ssm._mlstm_chunk_scan, self.tr.slstm_block)
        self.ssm._mlstm_chunk_scan = wrap(XLSTM_RANGES[0], self.saved[0])
        self.tr.slstm_block = wrap(XLSTM_RANGES[1], self.saved[1])

    def __exit__(self, *exc):
        self.ssm._mlstm_chunk_scan, self.tr.slstm_block = self.saved


#: The profiled xLSTM ranges: the mLSTM chunk loops and the sLSTM blocks
#: (their time loop and their two projections).
XLSTM_RANGES = ("xlstm::mlstm_chunk_loop", "xlstm::slstm_block")

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
    phase_sass_int()
    summary = phase_compare(torch)
    summary.update(phase_compare_fused(torch))
    summary.update(phase_compare_systolic_float(torch))
    launches = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    for path in (phase_serve, phase_serve_vgg16):
        add(path(torch, card))
    params = vgg16_params(torch)
    counts, ref, ref_imgs = phase_serve_vgg16_systolic(torch, card, params)
    add(counts)
    add(phase_serve_vgg16_bf16x3(torch, card, params, ref, ref_imgs))
    del params, ref
    torch.cuda.empty_cache()
    attn, decode_launches = phase_compare_attention(torch)
    phase_compare_lm_gemm(torch)
    summary.update(attn)
    add(decode_launches)
    granite = lm_params(torch)
    add(phase_prefill(torch, card, granite))
    for policy in ("native_bf16", "kom_int14"):
        add(phase_serve_lm(torch, card, granite, policy))
    del granite
    torch.cuda.empty_cache()
    phase_reduced_lm(torch)
    mlstm, mlstm_launches = phase_compare_mlstm(torch)
    summary.update(mlstm)
    add(mlstm_launches)
    xlstm = lm_params(torch, XLSTM)
    add(phase_prefill_xlstm(torch, card, xlstm))
    for policy in ("native_bf16", "kom_int14"):
        add(phase_serve_lm(torch, card, xlstm, policy, XLSTM))
    del xlstm
    torch.cuda.empty_cache()
    phase_reduced_lm(torch, XLSTM)
    kernels = []
    for name in KERNELS:
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
