#!/usr/bin/env python3
"""Proof on an NVIDIA GPU that the port's AlexNet, VGG16, granite-3-2b,
xlstm-125m, olmoe-1b-7b, internvl2-26b, whisper-large-v3 and
recurrentgemma-9b paths run.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. report the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the CUDA kernels from ``repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the build time; count the int8 MMA
   opcodes (IMMA) in the SASS: all four integer libraries (the limb GEMM,
   the implicit, systolic and Winograd convs) must issue some;
3. hold each kernel against its plain PyTorch version on the card at
   AlexNet's full-width shapes (batch 16) under ``kom_int14`` and
   ``schoolbook_int16``: max abs difference must be 0; time both, and time
   the limb GEMM's three int8 passes through ``torch._int_mm`` as a
   yardstick, and for the implicit and Winograd convs the same passes
   over the im2col of the layer's int16 operands as ``raw_product_ms``
   (the raw product only; their ``library_ms`` stays null: no PyTorch
   call computes their quantization and epilogue); run the
   implicit kernel on Winograd's layers (conv3-5)
   with the same tile scales: its output must equal Winograd's bit for
   bit, and both are timed;
4. the same for the implicit kernel's pooled and handoff variants at every
   full-width VGG16 producer and consumer shape (batch 8), its plain
   epilogue at VGG16's three convs between them, and at AlexNet's conv2
   (pooled) and conv3 (handoff) (batch 16), both policies; each variant
   summed over one VGG16 forward beside its bound and the raw-product
   ``torch._int_mm`` yardstick of its convs (``raw_product_ms``: no
   pool, no handoff; ``library_ms`` null);
5. planning on the card: ``python -m repro_torch.core.planner --check``'s
   ``check()`` on the committed ``repro_torch/tuned/plans/cuda.json`` (no
   violation; the six plans -- alexnet, vgg16, vgg19 under both integer
   policies -- every layer ``source="measured"``); the measured explorer
   re-run over those six (batch 1, ``--requant``), each layer's wall,
   engine, fusion and ``annotate_plan`` roofline fraction printed beside
   the committed choice; the implicit engine's Cin-chunk (``bk``) sweep of
   one VGG16 layer (28 x 28, 512 -> 512) under both policies;
6. serve full-width AlexNet under ``kom_int14`` through ``CNNServeEngine``
   on the plan it resolves (the committed measured plan; buckets 1/4/16):
   warm up, then 32 requests; the launch counters, reset just before, must
   show per forward the launches the plan implies (``plan_launches``: one
   per conv on its engine and variant, one limb GEMM per FC), the logits
   must equal a forward through the plain versions on the card bit for
   bit, and a reduced AlexNet forward on the card must equal the plain
   version on the CPU (which the CPU tests hold against the JAX reference)
   bit for bit; then the same 32 requests on fresh engines, heuristic
   plan (the one AlexNet served before), heuristic, committed -- each
   with its own launch counts; the heuristic plan's first 16 logits equal
   its plain-version forward on the card bit for bit, and the committed
   plan's bit for bit unless a systolic layer or a ``pool_quant`` handoff
   quantizes with its own scales -- a profile of one heuristic step, and
   images/s of each run beside the card's name and power limit;
6b. serve full-width VGG16 under ``kom_int14`` through the fused plan of
   ``explore(cfg, model_only=True, requant=True)`` (buckets 1/4/8, 16
   requests): the plan must hold ``pool`` and ``pool_quant`` entries, the
   counters, reset just before, must show per forward 4 limb-GEMM, 5
   pooled, 4 handoff and 3 plain implicit-conv launches, the logits must
   equal the plain-version forward on the card bit for bit, and a reduced
   VGG16 forward under its fused plan on the card must equal the CPU plain
   versions bit for bit; then the same 16 requests on fresh engines,
   committed measured plan, committed, fused (launches per
   ``plan_launches``; the committed plan's first 8 logits equal to its
   plain-version forward bit for bit), a profile of one committed step,
   and images/s of each run beside the card's name and power limit;
6c. chaos: phase 6's 32 AlexNet requests on the committed plan (buckets
   1/4/16) under ``FaultPlan(seed=1, transient_rate=1.0,
   transient_fails=1, poison_uids=(3,))`` with retries on a fake clock:
   conservation, uid 3 alone failed typed, retries taken, health
   ``healthy``, every served logit equal to phase 6's bit for bit, launch
   counts per successful forward; images/s beside phase 6's;
6d. a genuine CUDA OOM three times (a forward that first allocates twice
   the card's memory): the ladder drops buckets 16 and 4 and reroutes to
   the materialized im2col plan, the next forwards succeed; on the
   heuristic plan the degraded logits equal the healthy ones bit for bit,
   on the committed plan (systolic layers) the fallback plan's
   plain-version forward on the card, the distance from the healthy
   logits logged;
6e. the dispatcher on one card and one fake clock: AlexNet and VGG16
   (committed plans) and xlstm-125m (``kom_int14``, 4 slots); a VGG16
   ``batch`` backlog, then ``interactive`` AlexNet and ``standard`` xlstm
   requests: AlexNet drains first, every model conserves, each CNN's
   logits equal its solo engine's (phases 6 and 6b) bit for bit, the
   xlstm's greedy tokens a solo run's, also under transient faults with
   retries; launches per forward and serve_step;
6f. the launcher in-process on the real clock: ``--arch alexnet,vgg16
   --policy kom_int14 --requests 8 --slo standard --fault-plan
   transient=0.2,poison=0.05`` (buckets 1/4/16) returns 0 with one fleet
   line, and for each model: conservation, no request expired, the
   failed uids exactly those the seeded plan poisons, every fault the
   engine recorded one the injector injected, health ``healthy`` and
   nothing contained, launches per warmup and served forward as the plan
   implies, and the served logits equal to a fault-free forward of the
   same images bit for bit;
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
   GEMM, and for the integer systolic conv ``torch._int_mm`` once per
   int8 pass over the im2col of its int16 input, split into digit planes
   before timing; each conv's sum over the 13 convs of one forward beside
   the library's and the bound;
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
    must issue wgmma, the f32 kernel TF32 ``mma.sync``), then hold the
    flash-attention kernel against its plain version on the card at one
    full-width granite-3-2b prefill layer
    (b 4, hq 32, hkv 8, sq = skv = 2048, dh 64, causal), at sq 256 with
    q_offset 1792 and with window 512, each in f32 and bf16, and at sq =
    skv = 1000 (padded); the flash-decode kernel at b 8, hq 32, hkv 8, S
    4096, dh 64, pos 0/1000/4095 (f32, and bf16 at 4095 and at 3), -1
    (every key masked) and S 4000 (padded).  f32 within ATTN_TOL_F32 and
    bf16 within ATTN_TOL_BF16 (attention also row by row within
    ATTN_ROW_TOL_BF16, which a plain version skipping a middle key tile
    must miss), the mutant plain version (causal ``>`` for
    ``>=``; decode ``<`` for ``<=``) required to miss the tolerance (f32;
    bf16 where q_offset is 0, so that the first row's only key is the one
    the mutant drops, and for decode at pos 3, where the dropped key
    carries a quarter of the weight); timed beside
    ``F.scaled_dot_product_attention`` with the same mask (a yardstick the
    port never calls; decode and SDPA also replayed from a CUDA graph,
    device time alone, the JSON row's time) and the ``analysis/roofline``
    bound (bf16 inputs at the bf16 peak; f32 ones at the f32 CUDA-core
    peak, with the floor of three TF32 passes beside it); then the decode
    op's own run (its entry point, no model calls it);
11. full-width granite-3-2b (40 layers, random weights, seed 0): the
    prefill step (``make_prefill_step``, ``use_flash_kernel=True``) on 4 x
    2048 tokens under ``native_bf16`` -- 40 flash-attention launches per
    forward, prefill tokens/s, a profile -- and under ``fp32`` (TF32 off)
    the logits within PREFILL_TOL_FP32 of the same forward inside
    ``build.plain_versions()``, then timed (prefill tokens/s);
12. the limb GEMM at granite-3-2b's decode shapes (``limb_gemm_shapes``:
    one row per distinct (k, n)) at m = 1, 4 and 16, exact against its
    plain version, with the K split its plan chose, eager and CUDA-graph
    device times beside ``torch._int_mm``, and the per-serve_step totals;
    serve full-width granite-3-2b through ``ServeEngine`` (slots 4,
    max_len 512, 8 requests by the launcher's prompt rule, max_new 12)
    under ``native_bf16`` and ``kom_int14``: all 8 done, decode tokens/s,
    p50/p95 engine-step time, under ``kom_int14`` 281 limb-GEMM launches
    per serve_step, two requests re-served alone with the same greedy
    tokens (the batched-vs-solo max |d logit| printed), a decode profile;
13. reduced granite-3-2b (flash kernel on) under ``fp32`` and
    ``kom_int14``: the forward and four decode steps on the card within
    REDUCED_TOL_FP32 / REDUCED_TOL_KOM of the CPU plain versions;
14. count the TF32 ``mma.sync`` instructions (``HMMA``) in the mLSTM
    library's SASS (there must be some), then hold the chunkwise-mLSTM
    kernels against their plain version (the
    model's chunk loop, f32) at one full-width xlstm-125m layer (b 4, h 4,
    s 2048, dh 384, chunk 64) in f32 and bf16, at s 2000 (padded) and 17
    (< chunk), with strong forget gates (log_f ~ -5), with zero input-gate
    rows and at 1 x 4 x 32768 (``prefill_32k``'s length, 512 chunks):
    within MLSTM_TOL of max |plain|, the two mutant plain versions (the
    causal mask without its diagonal, the state written without the input
    gate) required to miss it; timed beside the ``analysis/roofline``
    bound (f32 CUDA-core peak) and the floor of three TF32 passes (no
    PyTorch call computes the chunkwise mLSTM); then the op's own run (its
    entry point, no model calls it, as in the reference: one counted
    launch, the state walk and the outputs);
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
19. the flash-attention kernel at one full-width olmoe-1b-7b prefill
    layer (b 4, hq = hkv = 16, sq = skv = 2048, dh 128, causal) in f32 and
    bf16, as phase 10 (tolerances, mutant, SDPA, bound);
20. full-width olmoe-1b-7b (16 layers, 64 experts, top-8, random weights,
    seed 0): the prefill step (flash kernel on) on 4 x 2048 tokens under
    ``native_bf16`` -- 16 flash-attention launches, tokens/s, a profile
    with the routing, dispatch, expert products and combine as ranges --
    and under ``fp32`` (TF32 off) the plain-version forward with every
    layer's routing recorded, then the kernel forward with ``moe_route``
    pinned to that routing within PREFILL_TOL_FP32 of max |logit| (an ulp
    can flip a top-8 choice, which moves a token's output by O(1)), and an
    unpinned kernel forward whose flipped (token, layer) routings are
    counted, a finding and not a limit; then layer 0's MoE FFN on 4 x 2048
    tokens in f32, card against CPU: the same experts (or CPU near ties),
    positions and drops, y and aux within MOE_TOL_FFN_F32 / MOE_TOL_AUX,
    and within them again with the card's routing pinned to the CPU's;
21. the limb GEMM at olmoe-1b-7b's decode shapes as phase 12 (q/k/v/o
    2048 x 2048, 64 per serve_step, and the untied head 2048 x 50432);
    serve full-width olmoe-1b-7b as phase 12 (slots 4: each decode
    group's capacity is 4 per expert, so nothing is dropped and batched ==
    solo holds; 65 limb-GEMM launches per serve_step under ``kom_int14``:
    q, k, v, o per layer and the head -- the router and the experts run
    in the compute dtype, as in the reference);
22. reduced olmoe-1b-7b as phase 13, with every (token, layer) routed
    alike on the card and the CPU;
23. the flash-attention kernel at one full-width internvl2-26b prefill
    layer (b 4, hq 48, hkv 8, sq = skv = 2048, dh 128, causal: six q
    heads a kv head on the dh-128 kernels) in f32 and bf16, as phase 19;
24. full-width internvl2-26b (48 layers, random weights, seed 0) with
    bf16 params (19.863 B: 79.5 GB in the config's f32 leave no room on
    one card, 39.7 GB in bf16): the prefill step (flash kernel on) on 4 x
    2048 tokens with seeded ``img_embeds`` (4, 256, 6144) under
    ``native_bf16`` -- 48 flash launches, tokens/s, a profile -- its
    logits within PREFILL_TOL_BF16 of the same step on the plain attention
    path (under ``fp32``, one sequence: within PREFILL_TOL_FP32), and
    other token ids at the 256 image positions giving the same logits bit
    for bit;
25. serve full-width internvl2-26b as phase 12 (the dense stack, no
    images, as in the reference; under ``kom_int14`` the engine quantizes
    the stacked weights one layer at a time: 337 limb-GEMM launches per
    serve_step, q, k, v, o, gate, up and down per layer and the untied
    head);
26. the limb GEMM at whisper-large-v3's encoder shapes (m = 4 x 1500 rows,
    q/k/v/o 1280 x 1280, up 1280 x 5120, down 5120 x 1280, with a bias)
    exact against its plain version, beside ``torch._int_mm`` and the
    bound; then full-width whisper-large-v3 (32 + 32 layers, f32 params,
    flash kernel off: 1500 frames fill no 128-key block and a non-causal
    flash call refuses them, as in the reference) under ``native_bf16``,
    ``fp32`` and ``kom_int14``: the prefill step on seeded ``audio_embeds``
    (4, 1500, 1280) and 4 x 448 tokens (tokens/s; under ``kom_int14`` 513
    limb-GEMM launches and the logits equal to the plain-version forward
    bit for bit), ``encode`` (256) and 12 greedy decode steps at batch 4
    (257 each) held against the teacher-forced forward of the tokens they
    were fed within DECODE_TOL of max |logit|;
27. reduced internvl2-26b and whisper-large-v3 (flash kernel on; whisper's
    16 frames fill one key block) as phase 13, with their embeddings,
    whisper encoding before its decode steps;
28. the flash-attention kernel at recurrentgemma-9b's attention layer
    (hq 16, hkv 1: MQA 16:1, dh 256, causal, window 2048) at b 4 x 2048
    (the window cuts nothing) and 1 x 8192 (it does), in f32 and bf16, as
    phase 19 (the bf16 row-by-row mutant skips a middle 32-key tile, the
    dh-256 kernels' tile); first their shared memory a block and ptxas
    registers and spills;
29. full-width recurrentgemma-9b (38 layers: 12 groups of (rglru, rglru,
    attn) and 2 RG-LRU tail blocks, f32 params, 9.396 B, random weights,
    seed 0): the prefill step (flash kernel on) on 4 x 2048 tokens under
    ``native_bf16`` -- 12 flash launches, tokens/s, a profile with each
    RG-LRU associative scan as a range -- its logits within
    PREFILL_TOL_BF16 of the plain attention path's, and under ``fp32``
    (TF32 off) within PREFILL_TOL_FP32, timed;
30. one attention block's ring decode at b 4 from a pre-filled ring of
    2048 slots at pos 2047, 2048 and 5000 (wrapped) in f32, within
    RING_TOL of plain attention over the explicit last 2048 positions,
    the ring's other slots kept bit for bit; then 16 teacher-forced
    ``serve_step`` s under ``fp32`` within DECODE_TOL of the forward;
31. the limb GEMM at recurrentgemma's decode shapes as phase 12 (4096 x
    4096, 4096 x 256, 4096 x 12288, 12288 x 4096 and the tied head 4096 x
    256000); serve full-width recurrentgemma-9b as phase 12 under
    ``fp32`` (batched == solo greedy tokens required), ``native_bf16``
    and ``kom_int14`` (293 limb-GEMM launches a serve_step; batched vs
    solo reported, with the op that ties a row to its batch-mates);
32. reduced recurrentgemma-9b as phase 13, twelve decode steps through a
    ring of 8 slots (it wraps);
33. print the card line, a ``kernels`` JSON line (launches: the serving
    runs, phases 6c-6f, the fp32 yardstick forward, the granite, olmoe,
    internvl2, whisper and recurrentgemma prefill forwards, whisper's
    encode and decode steps and the two ops' own runs, each counted from
    0;
    ``library_ms`` one PyTorch call computing the same function, else null;
    ``raw_product_ms`` the implicit and Winograd convs' raw integer
    product, else null) and, last, ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, without a CUDA device or without the
``repro_torch`` package beside it.
"""
from __future__ import annotations

import gc
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
#: bf16 attention outputs row by row: max|kernel - plain| in a row over the
#: row's max|plain|.  Two roundings of one f32 value lie one bf16 ulp apart
#: at most, and an ulp is at most 2^-7 of the value; the limit allows two.
#: ATTN_TOL_BF16 alone is one ulp of the largest outputs (O(1), in the
#: first rows) and so some 40 ulps of a late row's (~0.05 over 2048 keys).
ATTN_ROW_TOL_BF16 = 2.0 ** -6
#: Full-width granite fp32 prefill, flash kernel vs plain version, of max
#: |logit|: 40 layers carry the kernels' f32 reordering through the stack.
PREFILL_TOL_FP32 = 1e-4
#: One full-width MoE layer, card vs CPU in f32: ``tests/test_torch_moe.py``'s
#: TOL_FFN_F32 of max |y| (the expert products summed in another order)
#: and TOL_AUX of aux (the same f32 probabilities averaged).
MOE_TOL_FFN_F32 = 1e-5
MOE_TOL_AUX = 1e-6
#: A (token, rank) routed to different experts on the card and the CPU
#: must be a near tie: the two experts' CPU probabilities this close (a
#: 1e-6 logit difference moves a probability of ~0.1 by ~1e-7; a wrong
#: choice misses by the gap between ranks, ~1e-2).
ROUTE_TIE_EPS = 1e-6
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
    -sass``): all four integer libraries -- the limb GEMM, the implicit,
    systolic and Winograd convs -- must issue int8 MMAs (IMMA)."""
    from repro_torch.kernels import build

    counts = {name: build.sass_count(name, "IMMA")
              for name in ("kom_matmul", "implicit_conv", "systolic_conv",
                           "winograd")}
    log(f"[sass] IMMA (int8 mma.sync) instructions per library: {counts}")
    missing = [name for name, c in counts.items() if not c]
    if missing:
        raise SystemExit(f"[sass] integer kernels issue no IMMA: {missing}")


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
        tile_scales_upsampled, winograd_weight_planes)
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
    # Winograd: conv3-5, 3x3 at 13x13, SAME.  The last item of a call is
    # the implicit engine on the same layer with the same tile scales (the
    # reference holds the two bitwise equal): Winograd's raw sums are 4x
    # the conv's and its channel scale a quarter, both exact.
    for label, cin, cout in (("conv3", 256, 384), ("conv4", 384, 384),
                             ("conv5", 384, 256)):
        x = torch.relu(randn((BATCH, 13, 13, cin)))
        wv = ints((3, 3, cin, cout))
        uh, ul = winograd_weight_planes(wv, bb)
        s_tile = tile_scales_from_cmax(
            F.pad(channel_absmax(x), (1, 1, 1, 1)), qmax, 7, 7).contiguous()
        ws4, bias = pos((cout,)), randn((cout,))
        run = (lambda x=x, uh=uh, ul=ul, s=s_tile, ws4=ws4, bias=bias:
               conv2d_winograd_raw(x, uh, ul, s, ws4, bias, pads=(1, 1),
                                   out_hw=(13, 13), variant=variant,
                                   base_bits=bb))
        asc = tile_scales_upsampled(s_tile, 13, 13).contiguous()
        implicit = (lambda x=x, wv=wv, asc=asc, ws=ws4 * 4, bias=bias:
                    conv2d_implicit_raw(x, wv, asc, ws, bias, stride=1,
                                        pads=(1, 1), out_hw=(13, 13),
                                        span_c=cin, variant=variant,
                                        base_bits=bb))
        ops = 2.0 * 16 * BATCH * 49 * cin * cout * passes
        nbytes = 4 * x.numel() + 2 * (uh.numel() + ul.numel()) \
            + 4 * s_tile.numel() + 8 * cout + 4 * BATCH * 13 * 13 * cout
        calls.append(("winograd", label, run, ops, nbytes,
                      (x, uh, implicit, wv)))
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


def im2col_int_mm_ms(torch, xq, wq, pad, variant, bb) -> float | None:
    """Yardstick for the systolic conv: its int8 passes as ``torch._int_mm``
    calls over the im2col of the int16 input and the flat weight, both
    built and split into digit planes before timing."""
    import torch.nn.functional as F
    n, h, w, cin = xq.shape
    kh, kw, _, cout = wq.shape
    xp = F.pad(xq, (0, 0, pad, pad, pad, pad))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(kh)
                      for dx in range(kw)], dim=3)
    return int_mm_passes_ms(torch, cols.reshape(n * h * w, kh * kw * cin),
                            wq.reshape(kh * kw * cin, cout), variant, bb)


def raw_product_ms(torch, x, wq, variant, bb) -> float | None:
    """Yardstick for the implicit and Winograd convs, which quantize their
    float input inside the kernel: ``im2col_int_mm_ms`` on ``x`` quantized
    per tensor to the policy's int16 levels (SAME padding), i.e. the raw
    integer product alone -- no quantization, scales, epilogue or pool."""
    from repro_torch.core.substrate import kom_qmax
    if x.dtype != torch.int16:
        x = torch.round(x * (kom_qmax(bb) / x.abs().amax().clamp_min(
            1e-30))).to(torch.int16)
    return im2col_int_mm_ms(torch, x, wq, wq.shape[0] // 2, variant, bb)


def compare_call(torch, build, policy, name, label, run, ops, nbytes,
                 lib_ms=None, kind="int8", tol=None, control=None,
                 raw_ms=None) -> tuple:
    """Kernel vs plain version on the same inputs, then timed: exact, or
    with ``tol`` max|kernel - plain| <= tol * max|plain|, while the plain
    version of the neighbouring schedule (``control()``) misses ``tol``.
    ``raw_ms`` (logged only) is the ``raw_product_ms`` yardstick of a conv
    that no PyTorch call computes whole.  Returns (max_abs_err, kernel ms,
    plain ms)."""
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
        + ("" if raw_ms is None else f"raw_product_ms={raw_ms:.4f} ")
        + f"bound_ms={b_ms:.5f} ({b_by}, {kind})")
    if nan or not ok:
        raise SystemExit(f"{name}/{label}/{policy}: kernel != plain "
                         f"(max_abs_err={err}, max_rel={rel}, tol={tol}, "
                         f"neighbour gap={gap}, nan={nan})")
    return err, ms, plain_ms


def add_summary(summary, name, err, ms, plain_ms, ops, nbytes, lib_ms,
                has_library, kind="int8", raw_ms=None):
    """Sum one call into ``summary[name]``.  ``library_ms`` is one PyTorch
    call computing the same function (None where there is none);
    ``raw_product_ms`` the raw integer product alone (the
    ``raw_product_ms`` yardstick), kept apart so that ``library_ms`` has
    one meaning in every row."""
    s = summary.setdefault(name, {
        "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
        "library_ms": 0.0 if has_library else None,
        "raw_product_ms": None if raw_ms is None else 0.0,
        "max_abs_err": 0.0, "ops": 0.0, "bytes": 0.0, "kind": kind})
    if s["raw_product_ms"] is not None:
        s["raw_product_ms"] = None if raw_ms is None \
            else s["raw_product_ms"] + raw_ms
    s["ms"] += ms
    s["plain_ms"] += plain_ms
    s["ops"] += ops
    s["bytes"] += nbytes
    s["max_abs_err"] = max(s["max_abs_err"], err)
    if s["library_ms"] is not None:
        s["library_ms"] = None if lib_ms is None else s["library_ms"] + lib_ms


def winograd_vs_implicit(torch, policy, label, run, implicit) -> tuple:
    """The implicit engine on a Winograd layer, same tile scales: its
    output must equal Winograd's bit for bit; both timed."""
    got, want = run(), implicit()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit(f"winograd/{label}/{policy}: Winograd != implicit "
                         f"(max_abs_err={float((got - want).abs().max())})")
    w_ms = cuda_ms(run, iters=10)
    i_ms = cuda_ms(implicit, iters=10)
    log(f"[compare] {policy:16s} {label}: winograd == implicit engine bit "
        f"for bit; winograd_ms={w_ms:.4f} implicit_ms={i_ms:.4f}")
    return w_ms, i_ms


def phase_compare(torch) -> dict:
    from repro_torch.core.substrate import INT_POLICY_SPECS
    from repro_torch.kernels import build

    gen = torch.Generator().manual_seed(0)
    summary, engines = {}, {}
    for policy in POLICIES:
        variant, bb = INT_POLICY_SPECS[policy]
        for name, label, run, ops, nbytes, args in alexnet_calls(
                torch, policy, gen, torch.device("cuda")):
            lib_ms = raw_ms = None
            if name == "kom_matmul":
                lib_ms = int_mm_passes_ms(torch, args[0], args[1], variant,
                                          bb)
            else:   # the implicit conv (x, wv), Winograd (x, .., .., wv)
                raw_ms = raw_product_ms(torch, args[0], args[-1], variant,
                                        bb)
            err, ms, plain_ms = compare_call(torch, build, policy, name,
                                             label, run, ops, nbytes, lib_ms,
                                             raw_ms=raw_ms)
            if name == "winograd":
                t = engines.setdefault(policy, [0.0, 0.0])
                for i, v in enumerate(winograd_vs_implicit(
                        torch, policy, label, run, args[2])):
                    t[i] += v
            if policy == "kom_int14":
                add_summary(summary, name, err, ms, plain_ms, ops, nbytes,
                            lib_ms, name == "kom_matmul", raw_ms=raw_ms)
    for policy, (w_ms, i_ms) in engines.items():
        log(f"[compare] AlexNet conv3-5 ({policy}, batch {BATCH}): winograd "
            f"{w_ms:.4f} ms, the implicit engine on the same layers "
            f"{i_ms:.4f} ms (the same bits)")
    log("[compare] the implicit and Winograd convs have no single PyTorch "
        "call computing the same quantized limb arithmetic: library_ms null; "
        "raw_product_ms is torch._int_mm per int8 pass over the im2col of "
        "the same layer's int16 operands, the raw product only (no "
        "quantization, scales or epilogue)")
    for s in summary.values():
        s["bound_ms"], s["bound_by"] = bound_ms(s["ops"], s["bytes"],
                                                s["kind"])
    return summary


# ---------------------------------------------------------------------------
# Phase 4: the pooled and handoff variants, VGG16 and AlexNet shapes.
# ---------------------------------------------------------------------------

def fused_calls(torch, policy: str, gen, dev) -> list:
    """One (kernel, label, run, ops, bytes, lib) per pooled / handoff call
    (``lib()``: the ``raw_product_ms`` yardstick of its conv):
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
        lib = lambda: raw_product_ms(torch, x, wv, variant, bb)
        return ("implicit_conv_pool", label, run, ops, nbytes, lib)

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
        lib = lambda: raw_product_ms(torch, qa.values, wv, variant, bb)
        return ("implicit_conv_handoff", label, run, ops, nbytes, lib)

    def plain(label, n, h, cin, cout):
        _, _, run, ops, nbytes, lib = pooled(label, n, h, 3, cin, cout,
                                             pool=None)
        return ("implicit_conv", label, run, ops, nbytes, lib)

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
        for name, label, run, ops, nbytes, lib in fused_calls(
                torch, policy, gen, torch.device("cuda")):
            raw_ms = lib()
            err, ms, plain_ms = compare_call(torch, build, policy, name,
                                             label, run, ops, nbytes,
                                             raw_ms=raw_ms)
            if name == "implicit_conv":   # row 4a's VGG16 part, logged
                if policy == "kom_int14":
                    add_summary(vgg_plain, name, err, ms, plain_ms, ops,
                                nbytes, None, False, raw_ms=raw_ms)
            elif policy == "kom_int14" and label.startswith("v"):
                add_summary(summary, name, err, ms, plain_ms, ops, nbytes,
                            None, False, raw_ms=raw_ms)
            elif name in summary:
                s = summary[name]
                s["max_abs_err"] = max(s["max_abs_err"], err)
    s = vgg_plain["implicit_conv"]
    b_ms, b_by = bound_ms(s["ops"], s["bytes"], s["kind"])
    log(f"[compare] implicit_conv (plain epilogue) over one VGG16 forward "
        f"({len(VGG16_PLAIN)} convs, batch {VGG_BATCH}, kom_int14): "
        f"kernel_ms={s['ms']:.4f} plain_ms={s['plain_ms']:.4f} "
        f"raw_product_ms={s['raw_product_ms']} "
        f"bound_ms={b_ms:.4f} ({b_by}, {100 * b_ms / s['ms']:.1f}%)")
    for name in ("implicit_conv_pool", "implicit_conv_handoff"):
        s = summary[name]
        b_ms, b_by = bound_ms(s["ops"], s["bytes"], s["kind"])
        log(f"[compare] {name} over one VGG16 forward (batch {VGG_BATCH}, "
            f"kom_int14): kernel_ms={s['ms']:.4f} plain_ms="
            f"{s['plain_ms']:.4f} raw_product_ms={s['raw_product_ms']} "
            f"bound_ms={b_ms:.4f} ({b_by}, {100 * b_ms / s['ms']:.1f}%)")
    log("[compare] the pooled and handoff variants have no single PyTorch "
        "call computing the same function: library_ms null; "
        "raw_product_ms is torch._int_mm per int8 pass over the im2col of "
        "each conv's int16 operands, the raw product only (no pool, handoff "
        "quantization or epilogue)")
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
            lib_ms = None if label == alex2[0] else im2col_int_mm_ms(
                torch, xq, wq, pad, variant, bb)
            calls.append(("systolic_conv", policy, label, run,
                          2 * macs * passes, nbytes, "int8", None, lib_ms,
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
    summary, schoolbook, gemm = {}, [0.0, 0.0], {}
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
                schoolbook[0] += ms
                schoolbook[1] = (None if None in (lib_ms, schoolbook[1])
                                 else schoolbook[1] + lib_ms)
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
    s = summary["systolic_conv"]
    fmt = lambda v: "null" if v is None else f"{v:.4f}"
    log(f"[compare] systolic_conv over one VGG16 forward (13 convs, batch "
        f"{VGG_BATCH}): kom_int14 kernel_ms={s['ms']:.4f} library_ms="
        f"{fmt(s['library_ms'])}; schoolbook_int16 kernel_ms="
        f"{schoolbook[0]:.4f} library_ms={fmt(schoolbook[1])} (library: "
        "torch._int_mm over the im2col's digit planes, one call per pass)")
    for s in summary.values():
        s["bound_ms"], s["bound_by"] = bound_ms(s["ops"], s["bytes"],
                                                s["kind"])
    summary["systolic_conv_native"] = dict(summary["implicit_conv_native"])
    return summary


# ---------------------------------------------------------------------------
# Phase 5: serve full-width AlexNet through the kernels.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 5a: planning on the card -- the measured explorer, the bk sweep,
# the committed artifact's check.
# ---------------------------------------------------------------------------

#: The committed artifact's plans: the reference's committed models and
#: policies, each explored with --requant.
PLAN_MODELS = ("alexnet", "vgg16", "vgg19")


def plan_launches(cfg, plan, forwards: int) -> dict:
    """The kernel launches ``forwards`` forwards of ``cfg`` make under
    ``plan``: one per conv on the engine and variant the forward runs
    (``analysis/traffic.model_traffic``'s walk, ``cnn_forward``'s rule: a
    handoff consumer runs the implicit handoff variant, a pool fusion the
    pooled one), plus one limb-GEMM launch per FC layer."""
    from repro_torch.analysis.traffic import model_traffic

    counts: dict = {}
    for r in model_traffic(cfg, plan)["layers"]:
        if r["path"] == "implicit":
            name = ("implicit_conv_handoff" if r["handoff_in"] else
                    "implicit_conv_pool"
                    if r["fusion"] in ("pool", "pool_quant")
                    else "implicit_conv")
        else:
            name = {"im2col": "kom_matmul", "winograd": "winograd",
                    "systolic": "systolic_conv"}[r["path"]]
        counts[name] = counts.get(name, 0) + forwards
    n_fc = sum(1 for spec in cfg.layers if spec[0] == "fc")
    counts["kom_matmul"] = counts.get("kom_matmul", 0) + n_fc * forwards
    return counts


def plan_ab(torch, cfg, params, imgs, buckets, card, runs, first=None,
            profile_label=None) -> tuple:
    """Serve ``imgs`` once per ``(label, plan)`` of ``runs`` (``None``: the
    plan the engine resolves, the committed one), each on a fresh engine
    with the counters reset just before (``serve_burst``) and its launches
    held to ``plan_launches``; hold each label's first logits against a
    forward of the same engine through the plain versions on the card, bit
    for bit (``first``: an earlier, already checked run's (label, stats,
    wall) whose rate to include); log each label's images/s; profile one
    step of the ``profile_label`` engine.  Returns (launches, {label:
    logits of its first run})."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.serving.cnn_engine import CNNServeEngine

    launches, logits, rates, checked = {}, {}, {}, set()
    if first is not None:
        label, st, wall = first
        rates[label] = [(st["images_per_s"], len(imgs) / wall)]
        checked.add(label)
    x_check = torch.from_numpy(imgs[:max(buckets)]).cuda()
    for label, plan in runs:
        eng = CNNServeEngine(cfg, params, buckets=buckets, device="cuda",
                             plan=plan)
        tag = f"{cfg.name}-{label.split()[0]}"
        out, counts, fwd, wall = serve_burst(torch, eng, imgs, tag)
        check_launches(tag, counts, plan_launches(cfg, eng.plan, fwd))
        if label not in checked:
            checked.add(label)
            log(f"[{tag}] {label} plan: " + ", ".join(
                f"{e.key} {e.path}/{e.fusion}" for e in eng.plan.entries))
            with build.plain_versions():
                plain = eng.forward(x_check).cpu().numpy()
            got = out[:len(x_check)]
            if not np.array_equal(plain, got):
                raise SystemExit(f"[{tag}] {label} plan: engine logits != "
                                 "plain forward on the card (max diff "
                                 f"{np.abs(plain - got).max()})")
            log(f"[{tag}] {label} plan: engine logits == plain-version "
                "forward on the card, bitwise")
        if label == profile_label and label not in logits:
            phase_profile(torch, eng, imgs[:max(buckets)])
        logits.setdefault(label, out)
        rates.setdefault(label, []).append(
            (eng.stats()["images_per_s"], len(imgs) / wall))
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    for label, rs in rates.items():
        log(f"[plan-serve] {cfg.name}/{cfg.policy.value} {label} plan on "
            f"{card}: " + "; ".join(f"{b:.1f} img/s batched, {w:.1f} wall"
                                    for b, w in rs))
    return launches, logits


def phase_plan(torch, card: str) -> dict:
    """Explore the six committed plans on the card (batch 1, per-layer
    walls and each plan's ``annotate_plan`` roofline fractions), sweep the
    implicit engine's Cin chunk on one VGG16 layer, and check the
    committed artifact.  Returns the committed plans."""
    from repro_torch.analysis.roofline import annotate_plan
    from repro_torch.configs import get_config
    from repro_torch.core import planner, tuning
    from repro_torch.core.precision import MatmulPolicy

    t0 = time.perf_counter()
    errors = planner.check()
    committed = planner.load_plans(planner.plan_path("cuda"), backend="cuda")
    log(f"[plan] check of {planner.plan_path('cuda').name}: "
        f"{len(errors)} violation(s), plans {sorted(committed)}")
    if errors:
        raise SystemExit("[plan] " + "; ".join(errors))
    for name in PLAN_MODELS:
        for pv in POLICIES:
            key = planner.plan_key(name, pv)
            if key not in committed:
                raise SystemExit(f"[plan] the artifact lacks {key}")
            if {e.source for e in committed[key].entries} != {"measured"}:
                raise SystemExit(f"[plan] {key}: not every layer measured")
    agree = total = 0
    for name in PLAN_MODELS:
        for pv in POLICIES:
            cfg = get_config(name, policy=MatmulPolicy(pv))
            plan = annotate_plan(planner.explore(
                cfg, requant=True, backend="cuda", device="cuda"))
            ref = committed[planner.plan_key(name, pv)]
            for e in plan.entries:
                if e.source != "measured":
                    raise SystemExit(f"[plan] {name}/{pv} {e.key}: "
                                     f"source {e.source}")
                old = ref.by_key[e.key]
                agree += (old.path, old.fusion) == (e.path, e.fusion)
                total += 1
                log(f"[plan] {name}/{pv} {e.key}: {e.path}/{e.fusion} "
                    f"block={list(e.block) if e.block else '-'} "
                    f"{e.est_us:.1f} us (committed {old.path}/{old.fusion} "
                    f"{old.est_us} us), roofline {e.roofline_us:.2f} us, "
                    f"frac {e.roofline_frac:.4f}")
            fracs = [e.roofline_frac for e in plan.entries]
            wall_us = sum(e.est_us for e in plan.entries)
            log(f"[plan] {name}/{pv}: {wall_us:.1f} us over {len(fracs)} "
                "layers at batch 1, roofline_frac "
                f"min {min(fracs):.4f} max {max(fracs):.4f}")
    log(f"[plan] this run's ranking == the committed one on {agree} of "
        f"{total} layers; explored in {time.perf_counter() - t0:.1f}s "
        f"on {card}")
    geo = dict(kh=3, kw=3, stride=1, h=28, cin=512, cout=512)
    for pv in POLICIES:
        variant, base_bits = planner._policy_variant(pv)
        cache = tuning.TuneCache("unsaved.json")
        log(f"[plan] bk sweep, vgg16 {geo} {pv} (batch 1):")
        best = tuning.tune_layer("implicit", variant=variant,
                                 base_bits=base_bits, cache=cache,
                                 verbose=True, device="cuda", **geo)
        log(f"[plan]   best block {list(best)}: {cache.entries}")
    return committed


def random_biases(torch, params: list, gen) -> list:
    """``cnn_init`` zeroes every bias; fill them (0.1 * randn from ``gen``)
    so the bitwise checks cover each layer's bias epilogue."""
    for p in params:
        if "b" in p:
            p["b"] = (0.1 * torch.randn(p["b"].shape, generator=gen)).to(
                p["b"].device)
    return params


def phase_serve(torch, card: str) -> tuple:
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
    log("[serve] plan (resolved): " + ", ".join(
        f"{e.key} {e.path}/{e.fusion} ({e.source})"
        for e in eng.plan.entries))
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
    want = plan_launches(cfg, eng.plan, forwards)
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
    # The plan AlexNet served before the measured artifact: the heuristic;
    # both plans again on fresh engines (committed, heuristic, heuristic,
    # committed).
    from repro_torch.core.planner import heuristic_plan
    heur = heuristic_plan(cfg)
    ab, h_logits = plan_ab(torch, cfg, params, imgs, (1, 4, 16), card,
                           [("heuristic", heur), ("heuristic", heur),
                            ("committed", None)],
                           first=("committed", s, wall),
                           profile_label="heuristic")
    # im2col, implicit and Winograd share one activation-scale plan, so
    # their logits agree bit for bit; the systolic engine quantizes per
    # sample and a pool_quant handoff per 4x4 cell, which moves them.
    own_scales = [e.path == "systolic" or e.fusion == "pool_quant"
                  for e in eng.plan.entries + heur.entries]
    diff = float(np.abs(h_logits["heuristic"] - logits).max())
    if not any(own_scales) and diff != 0.0:
        raise SystemExit(f"[serve] heuristic-plan logits != committed-plan "
                         f"logits (max diff {diff}) on one scale plan")
    log(f"[serve] heuristic vs committed plan logits: max diff {diff:.3e}"
        + (" (a systolic or pool_quant layer quantizes with its own "
           "scales)" if any(own_scales) else " (bitwise)"))
    for name, n in ab.items():
        launches[name] = launches.get(name, 0) + n
    return launches, {"cfg": cfg, "params": params, "imgs": imgs,
                      "committed": logits, "heuristic": h_logits["heuristic"],
                      "rate": n_req / wall}


# ---------------------------------------------------------------------------
# Phase 6: serve full-width VGG16 through the fused plan.
# ---------------------------------------------------------------------------

def phase_serve_vgg16(torch, card: str) -> tuple:
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
    # The committed measured plan (the engine's default resolution), then
    # both plans again on fresh engines (fused, committed, committed,
    # fused); the first committed run's logits against the plain versions.
    del eng
    ab, ab_logits = plan_ab(torch, cfg, params, imgs, (1, 4, 8), card,
                            [("committed", None), ("committed", None),
                             ("fused model-only", plan)],
                            first=("fused model-only", s, wall),
                            profile_label="committed")
    for name, n in ab.items():
        launches[name] = launches.get(name, 0) + n
    return launches, {"cfg": cfg, "params": params, "imgs": imgs,
                      "committed": ab_logits["committed"]}


# ---------------------------------------------------------------------------
# Phases 6c-6f: serving under faults, full width.
# ---------------------------------------------------------------------------

#: The chaos run's attempt budget: it must outlast the bisection depth.  A
#: 16-image batch holding the poisoned uid fails ``bisect_after`` = 2
#: times, then once at 8, 4 and 2 images; an innocent may then meet its
#: own transient fault alone: 6 failures before it serves, so 7 attempts
#: (with 6, innocents are quarantined; the CPU tests hold both).
CHAOS_ATTEMPTS = 7


def conserved(q) -> bool:
    """Every submitted request in exactly one ledger."""
    return len(q.done) + len(q.expired) + len(q.failed) == q.submitted_count


def same_logits(tag, done, want: dict) -> None:
    """Each served request's logits against ``want[uid]``, bit for bit."""
    import numpy as np
    bad = [u for u, row in want.items()
           if not np.array_equal(done[u].logits, row)]
    log(f"[{tag}] {len(want) - len(bad)} of {len(want)} served logits "
        "equal the fault-free run's, bitwise")
    if bad:
        raise SystemExit(f"[{tag}] logits differ from the fault-free run "
                         f"for uids {bad}")


def phase_chaos(torch, card: str, alex: dict) -> dict:
    """Phase 6c: AlexNet ``kom_int14`` on the committed plan (buckets
    1/4/16, the 32 requests of phase 6) under ``FaultPlan(seed=1,
    transient_rate=1.0, transient_fails=1, poison_uids=(3,))`` with
    ``RetryPolicy(max_attempts=CHAOS_ATTEMPTS, backoff_base=0.001)`` on a
    fake clock: every request conserved, uid 3 alone failed typed, retries
    taken, the
    engine healthy, every served logit equal to phase 6's fault-free run
    bit for bit, and the launches those forwards imply (a fault fires
    before its forward launches anything)."""
    from repro_torch.kernels import build
    from repro_torch.serving.clock import ManualClock
    from repro_torch.serving.cnn_engine import CNNServeEngine, ImageRequest
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.scheduler import Failed, RetryPolicy

    cfg, imgs = alex["cfg"], alex["imgs"]
    clk = ManualClock()
    eng = CNNServeEngine(
        cfg, alex["params"], buckets=(1, 4, 16), device="cuda", clock=clk,
        advance=clk.advance_to,
        faults=FaultPlan(seed=1, transient_rate=1.0, transient_fails=1,
                         poison_uids=(3,)),
        retry=RetryPolicy(max_attempts=CHAOS_ATTEMPTS, backoff_base=0.001))
    eng.warmup()
    steps0 = eng.batcher.steps
    build.reset_launches()
    t0 = time.perf_counter()
    for uid in range(len(imgs)):
        eng.submit(ImageRequest(uid=uid, image=imgs[uid]))
    done = eng.run()
    wall = time.perf_counter() - t0
    launches = build.launch_counts()
    forwards = eng.batcher.steps - steps0
    q, s = eng.request_queue, eng.stats()
    log(f"[chaos] alexnet/kom_int14 committed plan: {len(done)} done, "
        f"{len(q.expired)} expired, failed {sorted(q.failed)}, injected "
        f"{s['faults']['injected']}, retries {s['retries']}, bisections "
        f"{s['bisections']}, quarantined {s['quarantined']}, {forwards} "
        f"forwards, buckets {s['bucket_counts']}, health {eng.health}")
    if not conserved(q):
        raise SystemExit("[chaos] done + expired + failed != submitted")
    if sorted(q.failed) != [3] or not isinstance(q.failed[3], Failed):
        raise SystemExit(f"[chaos] failed {dict(q.failed)}, want uid 3")
    if sorted(done) != [u for u in range(len(imgs)) if u != 3] \
            or s["retries"] <= 0 or eng.health != "healthy":
        raise SystemExit(f"[chaos] done {sorted(done)}, retries "
                         f"{s['retries']}, health {eng.health}")
    same_logits("chaos", done, {u: alex["committed"][u] for u in done})
    check_launches("chaos", launches, plan_launches(cfg, eng.plan, forwards))
    log(f"[chaos] on {card}: {len(done) / wall:.1f} img/s wall under chaos "
        f"({len(done)} images in {wall:.3f}s), fault-free "
        f"{alex['rate']:.1f} img/s wall (phase 6)")
    return launches


def phase_oom(torch, card: str, alex: dict) -> dict:
    """Phase 6d: a genuine CUDA OOM, three times.  AlexNet engines
    (buckets 1/4/16, 16 requests) whose forward first allocates twice the
    card's memory, so that the allocator raises ``torch.OutOfMemoryError``:
    the ladder drops bucket 16, then bucket 4 (it sheds buckets while more
    than one remains), then reroutes to the materialized im2col plan; the
    next forwards succeed and every request is conserved.  On the
    heuristic plan (im2col, implicit, Winograd: one scale plan) the
    degraded logits equal the healthy ones bit for bit; on the committed
    plan (systolic layers) they equal the fallback plan's forward through
    the plain versions on the card bit for bit, and their distance from
    the healthy logits is logged."""
    import numpy as np

    from repro_torch.core.planner import heuristic_plan
    from repro_torch.kernels import build
    from repro_torch.serving.clock import ManualClock
    from repro_torch.serving.cnn_engine import CNNServeEngine, ImageRequest
    from repro_torch.serving.scheduler import RetryPolicy, classify_failure

    cfg, n = alex["cfg"], BATCH
    imgs = alex["imgs"][:n]
    total = torch.cuda.get_device_properties(0).total_memory
    launches = {}
    for label, plan in (("heuristic", heuristic_plan(cfg)),
                        ("committed", None)):
        tag = f"oom {label}"
        clk = ManualClock()
        eng = CNNServeEngine(cfg, alex["params"], buckets=(1, 4, 16),
                             device="cuda", plan=plan, clock=clk,
                             advance=clk.advance_to,
                             retry=RetryPolicy(max_attempts=6,
                                               backoff_base=0.001))
        eng.warmup()
        forward, left, raised = eng.forward, [3], []

        def oom_first(x, forward=forward, left=left, raised=raised):
            if left[0]:
                left[0] -= 1
                try:
                    torch.empty(2 * total, dtype=torch.uint8, device="cuda")
                except torch.OutOfMemoryError as e:
                    raised.append(e)
                    raise
                raise SystemExit(f"[{tag}] allocating twice the card's "
                                 "memory did not raise")
            return forward(x)

        eng.forward = oom_first
        steps0 = eng.batcher.steps
        build.reset_launches()
        for uid in range(n):
            eng.submit(ImageRequest(uid=uid, image=imgs[uid]))
        done = eng.run()
        counts = build.launch_counts()
        forwards = eng.batcher.steps - steps0
        del eng.forward
        s = eng.stats()
        log(f"[{tag}] raised {[type(e).__name__ for e in raised]} "
            f"({str(raised[0]).splitlines()[0][:90] if raised else '-'}), "
            f"classified {[classify_failure(e) for e in raised]}; "
            f"degrade_log {eng.degrade_log}, health {eng.health}, buckets "
            f"{eng.buckets}, {len(done)} done, {forwards} forwards")
        if len(raised) != 3 or {classify_failure(e) for e in raised} \
                != {"oom"} or s["fault_counts"]["oom"] != 3:
            raise SystemExit(f"[{tag}] want three OutOfMemoryErrors "
                             f"classified oom: {raised}, {s['fault_counts']}")
        if eng.degrade_log != ["dropped bucket 16", "dropped bucket 4",
                               "rerouted plan to materialized im2col"] \
                or eng.health != "degraded":
            raise SystemExit(f"[{tag}] ladder {eng.degrade_log}")
        if sorted(done) != list(range(n)) or not conserved(
                eng.request_queue):
            raise SystemExit(f"[{tag}] served {sorted(done)} of {n}")
        check_launches(tag, counts, plan_launches(cfg, eng.plan, forwards))
        for name, k in counts.items():
            launches[name] = launches.get(name, 0) + k
        got = np.stack([done[u].logits for u in range(n)])
        with build.plain_versions():
            plain = eng.forward(torch.from_numpy(imgs).cuda()).cpu().numpy()
        if not np.array_equal(got, plain):
            raise SystemExit(f"[{tag}] degraded logits != the fallback "
                             "plan's plain-version forward (max diff "
                             f"{np.abs(got - plain).max()})")
        d = float(np.abs(got - alex[label][:n]).max())
        log(f"[{tag}] degraded logits == the fallback plan's plain-version "
            f"forward on the card, bitwise; max |degraded - healthy| {d}")
        if label == "heuristic" and d != 0.0:
            raise SystemExit(f"[{tag}] degraded logits != healthy ({d}) on "
                             "a plan without systolic or pool layers")
    return launches


def phase_dispatch(torch, card: str, alex: dict, vgg: dict) -> dict:
    """Phase 6e: the dispatcher on one card, one fake clock: AlexNet and
    VGG16 (``kom_int14``, committed plans) and xlstm-125m (``kom_int14``,
    4 slots).  A VGG16 ``batch`` backlog of 16 images first, then 16
    AlexNet ``interactive`` images and 4 xlstm ``standard`` requests: the
    dispatcher must step AlexNet until its queue drains; every model
    conserves; each CNN's logits equal its solo engine's (phases 6 and
    6b) bit for bit; the xlstm's greedy tokens equal a solo ServeEngine
    run's, and again under ``FaultPlan(seed=2, transient_rate=0.5)`` with
    retries; launches as the forwards and serve_steps imply."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.serving.clock import ManualClock
    from repro_torch.serving.cnn_engine import CNNServeEngine, ImageRequest
    from repro_torch.serving.dispatcher import MultiModelDispatcher
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.scheduler import RetryPolicy

    clk = ManualClock()
    xcfg = get_config(XLSTM, policy=MatmulPolicy.KOM_INT14)
    xparams = lm_params(torch, XLSTM)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, xcfg.vocab_size, (int(rng.integers(3, 9)),)
                            ).astype(np.int32) for _ in range(4)]

    def xlstm_engine(**kw):
        return ServeEngine(xcfg, xparams, slots=4, max_len=64,
                           device="cuda", **kw)

    def xlstm_tokens(eng):
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=200 + i, prompt=p, max_new_tokens=8))
        return {u: r.out_tokens for u, r in eng.run().items()}

    disp = MultiModelDispatcher()
    engines = {"alexnet": CNNServeEngine(alex["cfg"], alex["params"],
                                         buckets=(1, 4, 16), device="cuda",
                                         clock=clk),
               "vgg16": CNNServeEngine(vgg["cfg"], vgg["params"],
                                       buckets=(1, 4, 8), device="cuda",
                                       clock=clk),
               XLSTM: xlstm_engine(clock=clk)}
    for name, eng in engines.items():
        if name != XLSTM:
            eng.warmup()
        disp.register(name, eng)
    serve_steps, decode = [0], engines[XLSTM]._decode

    def counted(*a):
        serve_steps[0] += 1
        return decode(*a)
    engines[XLSTM]._decode = counted
    steps0 = {n: engines[n].batcher.steps for n in ("alexnet", "vgg16")}
    build.reset_launches()
    t0 = time.perf_counter()
    n_vgg = len(vgg["imgs"])
    for uid in range(n_vgg):
        disp.submit("vgg16", ImageRequest(uid=uid, image=vgg["imgs"][uid],
                                          slo="batch"))
    for i in range(BATCH):
        disp.submit("alexnet", ImageRequest(uid=100 + i,
                                            image=alex["imgs"][i],
                                            slo="interactive"))
    for i, p in enumerate(prompts):
        disp.submit(XLSTM, Request(uid=200 + i, prompt=p, max_new_tokens=8,
                                   slo="standard"))
    order = []
    while disp.has_work():
        order.append(disp.step())
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    s = disp.stats()
    runs = []
    for name in order:
        if runs and runs[-1][0] == name:
            runs[-1][1] += 1
        else:
            runs.append([name, 1])
    log(f"[dispatch] order: " + ", ".join(f"{n} x{k}" for n, k in runs))
    log(f"[dispatch] steps per model {disp.steps_by_model}; fleet: "
        f"{s['requests_done']} done, {s['requests_expired']} expired, "
        f"{s['requests_failed']} failed, {s['retries']} retries, health "
        f"{s['health']}; {wall:.2f}s wall on {card}")
    n_alex = disp.steps_by_model["alexnet"]
    if order[:n_alex] != ["alexnet"] * n_alex:
        raise SystemExit("[dispatch] AlexNet's interactive queue did not "
                         "drain first")
    for name, eng in engines.items():
        if not conserved(eng.request_queue) or eng.request_queue.failed \
                or eng.request_queue.expired:
            raise SystemExit(f"[dispatch] {name} lost or failed requests")
    done = {n: engines[n].request_queue.done for n in engines}
    same_logits("dispatch alexnet", done["alexnet"],
                {100 + i: alex["committed"][i] for i in range(BATCH)})
    same_logits("dispatch vgg16", done["vgg16"],
                dict(enumerate(vgg["committed"])))
    want = dict(plan_launches(alex["cfg"], engines["alexnet"].plan,
                              engines["alexnet"].batcher.steps
                              - steps0["alexnet"]))
    for name, k in plan_launches(vgg["cfg"], engines["vgg16"].plan,
                                 engines["vgg16"].batcher.steps
                                 - steps0["vgg16"]).items():
        want[name] = want.get(name, 0) + k
    want["kom_matmul"] += serve_steps[0] * limb_gemms_per_step(xcfg)
    check_launches("dispatch", counts, want)
    tokens = {u: r.out_tokens for u, r in done[XLSTM].items()}
    solo = xlstm_tokens(xlstm_engine())
    log(f"[dispatch] xlstm tokens {tokens}; solo {solo}")
    if tokens != solo:
        raise SystemExit("[dispatch] xlstm tokens != a solo run's")
    fclk = ManualClock()
    chaos = xlstm_engine(clock=fclk, advance=fclk.advance_to,
                         faults=FaultPlan(seed=2, transient_rate=0.5),
                         retry=RetryPolicy(backoff_base=0.001))
    got = xlstm_tokens(chaos)
    cs = chaos.stats()
    log(f"[dispatch] xlstm under FaultPlan(seed=2, transient_rate=0.5): "
        f"injected {cs['faults']['injected']}, retries {cs['retries']}, "
        f"bisections {cs['bisections']}, tokens == fault-free: "
        f"{got == solo}")
    if got != solo or cs["faults"]["injected"]["transient"] == 0 \
            or not conserved(chaos.request_queue):
        raise SystemExit("[dispatch] xlstm under transient faults: tokens "
                         "differ, nothing injected, or a request lost")
    n_img = len(done["alexnet"]) + len(done["vgg16"])
    log(f"[dispatch] on {card}: {n_img} images and {len(tokens)} xlstm "
        f"requests in {wall:.3f}s ({n_img / wall:.1f} img/s wall beside "
        "the xlstm decode)")
    return counts


def phase_launcher(torch, card: str) -> dict:
    """Phase 6f: the launcher in-process on the real clock: ``--arch
    alexnet,vgg16 --policy kom_int14 --requests 8 --slo standard
    --fault-plan transient=0.2,poison=0.05`` (full width, the launcher's
    buckets 1/4/16) must return 0 with one fleet line.  The engines it
    builds are kept, and each must show: every request conserved, none
    expired, the failed uids exactly those the seeded plan poisons (typed
    ``Failed``), every fault its batcher recorded one its injector
    injected (so no kernel or wrapper error was retried away), health
    ``healthy`` with nothing contained, the launches of its warmup (two
    forwards per bucket) and served forwards as its plan implies, and
    served logits equal to a fault-free forward of the same images bit
    for bit."""
    import contextlib
    import io

    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.serving.faults import FaultInjector, FaultPlan
    from repro_torch.serving.scheduler import Failed

    spec, n_req = "transient=0.2,poison=0.05", 8
    argv = ["--arch", "alexnet,vgg16", "--policy", "kom_int14",
            "--requests", str(n_req), "--slo", "standard", "--fault-plan",
            spec]
    engines, build_engine = [], serve._build_engine

    def kept(cfg, args, device):
        engines.append(build_engine(cfg, args, device))
        return engines[-1]

    build.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    serve._build_engine = kept
    try:
        with contextlib.redirect_stdout(out):
            rc = serve.main(argv)
    finally:
        serve._build_engine = build_engine
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"[launcher] {line}")
    fleet = [ln for ln in lines if ln.startswith("[serve] fleet:")]
    log(f"[launcher] {' '.join(argv)}: rc {rc}, {wall:.2f}s with the "
        f"build of both engines, on {card}")
    if rc != 0 or len(fleet) != 1 or len(engines) != 2 \
            or any("contained:" in ln for ln in lines):
        raise SystemExit(f"[launcher] rc {rc}, fleet lines {fleet}, "
                         f"{len(engines)} engines, output {lines}")
    # the seeded plan's own poison decisions, independent of the engines
    poisoned = FaultInjector(FaultPlan.parse(spec, seed=0)).is_poison
    want, first = {}, 0
    for eng in engines:
        name, q, s = eng.cfg.name, eng.request_queue, eng.stats()
        uids = range(first, first + n_req)   # the launcher's uid order
        first += n_req
        injected = s["faults"]["injected"]
        recorded = sum(s["fault_counts"].values())
        poison = [u for u in uids if poisoned(u)]
        log(f"[launcher] {name}: {len(q.done)} done, {len(q.expired)} "
            f"expired, failed {sorted(q.failed)} (the plan poisons "
            f"{poison}), faults recorded "
            f"{s['fault_counts']}, injected {injected}, retries "
            f"{s['retries']}, bisections {s['bisections']}, health "
            f"{eng.health}, {eng.batcher.steps} served forwards, buckets "
            f"{s['bucket_counts']}")
        if q.submitted_count != n_req or not conserved(q) or q.expired:
            raise SystemExit(f"[launcher] {name}: {q.submitted_count} "
                             f"submitted, {len(q.done)} done, "
                             f"{len(q.expired)} expired, {len(q.failed)} "
                             "failed")
        if sorted(q.failed) != poison \
                or not all(isinstance(f, Failed) for f in q.failed.values()):
            raise SystemExit(f"[launcher] {name}: failed {dict(q.failed)} "
                             "!= the uids the plan poisons")
        if recorded != injected["transient"] + injected["poison"] \
                + injected["oom"]:
            raise SystemExit(f"[launcher] {name}: the batcher recorded "
                             f"{s['fault_counts']} faults, the injector "
                             f"injected {injected}")
        if eng.health != "healthy" or eng.degrade_log:
            raise SystemExit(f"[launcher] {name}: health {eng.health}, "
                             f"degrade_log {eng.degrade_log}")
        for k, v in plan_launches(eng.cfg, eng.plan, 2 * len(eng.buckets)
                                  + eng.batcher.steps).items():
            want[k] = want.get(k, 0) + v
        done = sorted(q.done)
        got = np.stack([q.done[u].logits for u in done])
        x = torch.from_numpy(np.stack([q.done[u].image for u in done]))
        free = eng.forward(x.cuda()).cpu().numpy()
        if got.shape != (len(done), eng.cfg.n_classes) \
                or not np.isfinite(got).all() or not np.array_equal(got,
                                                                     free):
            raise SystemExit(f"[launcher] {name}: served logits "
                             f"{got.shape} differ from a fault-free "
                             "forward of the same images")
        log(f"[launcher] {name}: {len(done)} served logits equal a "
            "fault-free forward of the same images, bitwise")
    check_launches("launcher", counts, want)
    return counts


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


def skip_keys(first, count):
    """Keys ``first .. first + count - 1`` masked: a kernel that skipped
    one key tile."""
    def make(orig):
        def live(q_pos, k_pos, *, causal, window):
            m = orig(q_pos, k_pos, causal=causal, window=window)
            return m & ~((k_pos >= first) & (k_pos < first + count))[None, :]
        return live
    return make


def middle_tile(sq, skv, *, causal, window, q_offset, tile):
    """The first key of the middle ``tile``-key tile among the last q
    row's live keys, or None if they span fewer than three tiles."""
    last = min(sq - 1 + q_offset, skv - 1) if causal else skv - 1
    lo = max(0, last - window + 1) if window is not None else 0
    t_lo, t_hi = lo // tile, last // tile
    return (t_lo + t_hi) // 2 * tile if t_hi - t_lo >= 2 else None


def row_err(got, want) -> float:
    """max over rows of max|got - want| in the row / max|want| in it."""
    got, want = got.float(), want.float()
    den = want.abs().amax(-1).clamp_min(1e-30)
    return float(((got - want).abs().amax(-1) / den).max())


def before_pos(orig):
    """Decode ``<`` for ``<=``: the key at ``pos`` masked."""
    return lambda k_pos, pos: k_pos < pos


def sdpa_ms(torch, q, k, v, mask, graph=False) -> float:
    """Yardstick: one ``F.scaled_dot_product_attention`` call with the same
    boolean mask (True = attend), GQA by ``enable_gqa``; never called by
    the port.  ``graph``: timed replayed from a CUDA graph.  ``mask`` None:
    ``is_causal=True`` instead (the same function where sq == skv and the
    q offset is 0; it may take a faster backend than a mask tensor)."""
    import torch.nn.functional as F

    timed = ((lambda fn: cuda_graph_ms(fn, iters=20)) if graph
             else (lambda fn: cuda_ms(fn, iters=10)))
    kw = dict(attn_mask=mask) if mask is not None else dict(is_causal=True)
    try:
        return timed(lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **kw))
    except (TypeError, RuntimeError) as e:  # no GQA in this build/backend
        log(f"  sdpa without enable_gqa ({e}): K/V repeated first")
        g = q.shape[1] // k.shape[1]
        k, v = (t.repeat_interleave(g, dim=1) for t in (k, v))
        return timed(lambda: F.scaled_dot_product_attention(q, k, v, **kw))


def attention_case(torch, build, summary, label, q, k, v, *, causal=True,
                   window=None, q_offset=0, row=False) -> None:
    """The flash-attention kernel against its plain version on the card:
    f32 within ATTN_TOL_F32, bf16 within ATTN_TOL_BF16 and row by row
    within ATTN_ROW_TOL_BF16, the strict-causal mutant required to miss
    the tolerance (f32; bf16 at q_offset 0), and for bf16 a plain version
    that skips the middle key tile of the kernel's (``bf16_key_tile``: 128
    keys at dh 128, 32 at dh 256, else 64) required to miss the row limit;
    timed beside SDPA and the roofline (bf16 inputs at the bf16 peak)."""
    from repro_torch.analysis.roofline import attention_roofline
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.flash_attention import (
        bf16_key_tile)

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
    rows = skip = first = None
    if not f32:
        rows = row_err(got, want)
        tile = bf16_key_tile(dh)
        first = middle_tile(sq, skv, causal=causal, window=window,
                            q_offset=q_offset, tile=tile)
        if first is not None:
            with mutated(FA_MOD, "live_mask", skip_keys(first, tile)), \
                    build.plain_versions():
                skip = row_err(got, run())
    pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = (pos >= kp) if causal else torch.ones_like(pos >= kp)
    if window is not None:
        mask &= (pos - kp) < window
    ms = cuda_ms(run, iters=10)
    with build.plain_versions():
        plain_ms = cuda_ms(run, iters=3, warmup=1)
    lib_ms = sdpa_ms(torch, q, k, v, mask)
    causal_sdpa = ""
    if causal and (window is None or window >= skv) and q_offset == 0 \
            and sq == skv:  # the window cuts nothing: the same function
        causal_sdpa = (f" (is_causal=True "
                       f"{sdpa_ms(torch, q, k, v, None):.4f})")
    rf = attention_roofline(b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, dh=dh,
                            causal=causal, window=window, q_offset=q_offset,
                            itemsize=q.element_size())
    b_ms, b_by = bound_ms(rf["flops"], rf["bytes"], rf["kind"])
    floor = (f" tf32x3_floor_ms={1e3 * rf['tf32x3_s']:.4f} "
             f"({100e3 * rf['tf32x3_s'] / ms:.1f}%)" if f32 else "")
    by_row = ("" if f32 else
              f" row_err={rows:.3e} (tol {ATTN_ROW_TOL_BF16:.3e}) "
              f"skip_keys_{first}_row_err={skip}")
    log(f"[attention] flash_attention {label} {str(q.dtype)[6:]}: "
        f"max_abs_err={err} (tol {tol}) mutant_err={miss}{by_row} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f}"
        f"{causal_sdpa} bound_ms={b_ms:.4f} ({b_by}, {rf['kind']}, "
        f"{100 * b_ms / ms:.1f}%){floor}")
    if not (err <= tol and torch.isfinite(got.float()).all()) or \
            (miss is not None and not miss > tol) or \
            (rows is not None and not rows <= ATTN_ROW_TOL_BF16) or \
            (skip is not None and not skip > ATTN_ROW_TOL_BF16):
        raise SystemExit(f"flash_attention {label}: kernel vs plain "
                         f"{err} (tol {tol}), mutant {miss}, by row {rows}, "
                         f"skipped tile {skip}")
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
    if not tc["HMMA"]:
        raise SystemExit("[attention] the f32 kernel issues no TF32 "
                         "mma.sync")
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


def limb_gemm_shapes(cfg) -> tuple:
    """The limb GEMMs of one dense, VLM, MoE or hybrid forward or
    serve_step under kom_int14, as ``(label, (k, n), count)``: q, k, v and
    o in each attention layer (dense, VLM: and the MLP's projections; MoE:
    the router and the experts are not on the limb substrate, as in the
    reference; hybrid: x, y, a, i and out in each RG-LRU block, and every
    block's GeGLU gate, up and down), then the head (tied or untied,
    ``padded_vocab`` wide).  Projections of one shape share a row, e.g.
    granite-3-2b's ``q/o`` (2048, 2048) x 80."""
    d, dq, f = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff
    dkv = cfg.n_kv_heads * cfg.head_dim
    n_attn = flash_layers(cfg)
    attn = [("q", (d, dq)), ("k", (d, dkv)), ("v", (d, dkv)), ("o", (dq, d))]
    rows = [(label, kn, n_attn) for label, kn in attn]
    if cfg.family in ("dense", "vlm"):
        mlp = [("gate", (d, f))] if cfg.mlp == "swiglu" else []
        rows += [(label, kn, cfg.n_layers)
                 for label, kn in mlp + [("up", (d, f)), ("down", (f, d))]]
    if cfg.family == "hybrid":
        dr, n_rnn = cfg.rnn_width, cfg.n_layers - n_attn
        rows += [(label, kn, n_rnn) for label, kn in (
            ("x", (d, dr)), ("y", (d, dr)), ("a", (dr, dr)), ("i", (dr, dr)),
            ("out", (dr, d)))]
        rows += [(label, kn, cfg.n_layers) for label, kn in (
            ("gate", (d, f)), ("up", (d, f)), ("down", (f, d)))]
    by_shape = {}
    for label, kn, count in rows:
        labels, n = by_shape.get(kn, ([], 0))
        by_shape[kn] = (labels + [label], n + count)
    return tuple(("/".join(labels), kn, n)
                 for kn, (labels, n) in by_shape.items()) + (
        ("head", (d, cfg.padded_vocab), 1),)


def flash_layers(cfg) -> int:
    """The self-attention layers of a decoder-only forward: one flash
    launch each with the kernel on (hybrid: the ``attn`` members of its
    groups)."""
    if cfg.family == "hybrid":
        return cfg.pattern_group.count("attn") * cfg.n_pattern_groups
    return cfg.n_layers


def limb_gemm_work(m: int, k: int, n: int) -> tuple[float, float]:
    """(int8 operations, bytes) of one limb GEMM at (m, k) x (k, n): three
    int8 products of the 7-bit limbs; int16 operands read once, the f32
    row and column scales read once, the f32 output written once."""
    return 2.0 * m * k * n * 3, 2 * (m * k + k * n) + 4 * (m + n + m * n)


#: The decode GEMM's rows: one slot, the served 4 slots, a full m16 tile.
DECODE_ROWS = (1, 4, 16)


def phase_compare_lm_gemm(torch, arch: str = "granite-3-2b") -> dict:
    """Phase 10b (granite-3-2b) and 21a (olmoe-1b-7b): the limb GEMM at
    each of ``arch``'s decode shapes (:func:`limb_gemm_shapes`) under
    kom_int14 at m = 1, 4 (the served slots) and 16: exact against its
    plain version, the K split of ``kom_split_k`` printed beside each
    shape, timed eagerly (the wrapper's Python dispatch included) and as
    device time replayed from a CUDA graph, beside its three int8 passes
    through ``torch._int_mm``; the per-serve_step totals weight each shape
    by its count.  Returns the m = 4 totals."""
    from repro_torch.configs import get_config
    from repro_torch.core.substrate import kom_qmax
    from repro_torch.kernels import build
    from repro_torch.kernels.kom_matmul import kom_matmul_int, kom_split_k

    shapes = limb_gemm_shapes(get_config(arch))
    calls = sum(count for _, _, count in shapes)
    gen = torch.Generator().manual_seed(5)
    qmax = kom_qmax(7)
    served = None
    for m in DECODE_ROWS:
        tot = {"ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bound_ms": 0.0}
        for label, (k, n), count in shapes:
            a = torch.randint(-qmax, qmax + 1, (m, k), generator=gen).to(
                torch.int16).cuda()
            b = torch.randint(-qmax, qmax + 1, (k, n), generator=gen).to(
                torch.int16).cuda()
            rs = (torch.rand(m, generator=gen) * 1e-3 + 1e-4).cuda()
            cs = (torch.rand(n, generator=gen) * 1e-3 + 1e-4).cuda()
            run = lambda a=a, b=b, rs=rs, cs=cs: kom_matmul_int(
                a, b, variant="karatsuba", base_bits=7, row_scale=rs,
                col_scale=cs)
            ops, nbytes = limb_gemm_work(m, k, n)
            plan = kom_split_k(m, k, n)
            what = f"kom_matmul {arch} {label} ({k}x{n}) m={m}"
            log(f"[compare] {what}: split {plan['splits']} x "
                f"{plan['group_k']} K entries, {plan['m_tile']}-row tile, "
                f"{plan['blocks']} blocks")
            lib_ms = int_mm_passes_ms(torch, a, b, "karatsuba", 7)
            err, ms, plain_ms = compare_call(
                torch, build, "kom_int14", "kom_matmul",
                f"{arch} {label} m{m}", run, ops, nbytes, lib_ms)
            graph_ms = cuda_graph_ms(run, iters=20)
            log(f"[compare] {what}: device time from a CUDA graph "
                f"{graph_ms:.4f} ms")
            b_ms, _ = bound_ms(ops, nbytes, "int8")
            for key, v in (("ms", ms), ("graph_ms", graph_ms),
                           ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bound_ms", b_ms)):
                tot[key] = None if v is None or tot[key] is None \
                    else tot[key] + count * v
        log(f"[compare] kom_matmul per {arch} serve_step ({calls} calls, "
            f"m = {m}): " + ", ".join(f"{k} {v if v is None else round(v, 4)}"
                                      for k, v in tot.items()))
        if m == 4:
            served = tot
    return served


def lm_params(torch, arch: str = "granite-3-2b", **cfg_kw):
    """Full-width float params of ``arch`` on the card (seed 0; ``cfg_kw``
    overrides the config, e.g. its ``param_dtype``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config(arch, **cfg_kw)
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n = sum(t.numel() for t in leaves)
    gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    log(f"[{arch}] {n / 1e9:.3f} B params ({cfg.param_dtype}, {gb:.1f} GB) "
        f"on the card in {time.perf_counter() - t0:.2f}s")
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def prefill_bf16(torch, card: str, params, arch: str, ranges=None,
                 embeds=None, **cfg_kw):
    """The ``native_bf16`` prefill step of ``arch`` with the flash kernel
    on 4 x 2048 tokens (and ``embeds``, more entries of the batch): one
    flash launch per layer (counted from 0 around one forward), finite
    logits, tokens/s over 3 forwards and a profile (``ranges``: see
    :func:`profile_step`).  ``cfg_kw`` overrides the config.  Returns
    (cfg, batch, the launches)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.step_fns import make_prefill_step

    cfg = get_config(arch, use_flash_kernel=True, **cfg_kw)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 2048)).astype(np.int64)).cuda()
    batch = {"tokens": tokens, **(embeds or {})}
    step = make_prefill_step(cfg)
    step(params, batch)
    torch.cuda.synchronize()
    build.reset_launches()
    logits = step(params, batch)
    torch.cuda.synchronize()
    launches = build.launch_counts()
    check_launches(f"prefill {arch}", launches,
                   {"flash_attention": flash_layers(cfg)})
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
    log(f"[prefill] {arch}/native_bf16 flash on {card}: "
        f"{1e3 * dt:.1f} ms per 4x2048 prefill, {4 * 2048 / dt:.0f} "
        "tokens/s")
    profile_step(torch, lambda: step(params, batch).sum().item(),
                 "one 4x2048 native_bf16 prefill step", ranges=ranges)
    return cfg, batch, launches


def phase_prefill(torch, card: str, params) -> dict:
    """Phase 11: the prefill step with the flash kernel, batch 4 x 2048."""
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.launch.step_fns import make_prefill_step

    cfg, batch, launches = prefill_bf16(torch, card, params, "granite-3-2b")
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
    del got, want
    n_it = 3
    t0 = time.perf_counter()
    for _ in range(n_it):
        step32(params, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_it
    log(f"[prefill] granite-3-2b/fp32 flash on {card}: {1e3 * dt:.1f} ms "
        f"per 4x2048 prefill, {4 * 2048 / dt:.0f} tokens/s")
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
    dense, VLM and MoE -- :func:`limb_gemm_shapes`; xLSTM -- 6
    prequantized projections plus ``w_if`` (``kom_q_dot``) per mLSTM,
    ``w_in`` and ``w_down`` per sLSTM; then the head; encoder-decoder --
    :func:`encdec_limb_gemms`' forward."""
    if cfg.family == "ssm":
        n_m = cfg.xlstm_group.count("m") * cfg.n_xlstm_groups
        n_s = cfg.xlstm_group.count("s") * cfg.n_xlstm_groups
        return 7 * n_m + 2 * n_s + 1
    if cfg.family == "encdec":
        return encdec_limb_gemms(cfg)["forward"]
    return sum(count for _, _, count in limb_gemm_shapes(cfg))


def encdec_limb_gemms(cfg) -> dict:
    """Limb-GEMM launches of an encoder-decoder under kom_int14: an
    encoder layer's q, k, v, o, up and down; a decoder layer's
    self-attention q, k, v, o, the cross-attention's q and o and its K/V
    of the encoder output, up and down; the tied head.  ``encode`` runs
    the encoder and every decoder layer's cross K/V, a decode ``step`` the
    decoder on the cache (its cross K/V read from it) and the head."""
    enc, dec = 6 * cfg.n_enc_layers, cfg.n_layers
    return {"forward": enc + 10 * dec + 1, "encode": enc + 2 * dec,
            "step": 8 * dec + 1}


def limb_gemm_step_bound_ms(cfg, m: int) -> float:
    """The bound (``bound_ms`` of :func:`limb_gemm_work`) of one dense or
    MoE serve_step's limb GEMMs at ``m`` rows."""
    return sum(count * bound_ms(*limb_gemm_work(m, k, n), "int8")[0]
               for _, (k, n), count in limb_gemm_shapes(cfg))


def phase_serve_lm(torch, card: str, params, policy: str,
                   arch: str = "granite-3-2b", donate: bool = False,
                   solo_must_match: bool = True, **cfg_kw) -> dict:
    """Phases 12, 17, 21, 25 and 31: full-width ``arch`` through
    ServeEngine: slots 4, max_len 512, 8 requests by the launcher's prompt
    rule, max_new 12; two requests re-served alone must give the same
    greedy tokens (``solo_must_match`` False: a difference is reported,
    with the op that makes a row depend on its batch-mates).  ``donate``:
    the engine quantizes ``params`` in place (they are spent); ``cfg_kw``
    overrides the config."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.serving.engine import Request, ServeEngine

    tag = f"serve_lm {arch} {policy}"
    cfg = get_config(arch, policy=MatmulPolicy(policy), **cfg_kw)
    # an earlier run's engine lives on in reference cycles (its recorder
    # and counters wrap its methods) and holds its params: collect it
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.family == "moe":
        # decode routes every slot row as one group: batched == solo only
        # while no expert can overflow (slots <= cap)
        from repro_torch.models.moe import moe_capacity
        cap = moe_capacity(4, cfg.moe_top_k, cfg.moe_num_experts,
                           cfg.moe_capacity_factor)
        log(f"[{tag}] decode group of 4 slot rows: capacity {cap} per "
            "expert, so nothing is dropped")
        if cap < 4:
            raise SystemExit(f"[{tag}] capacity {cap} < 4 slots")
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, slots=4, max_len=512, device="cuda",
                      donate=donate)
    torch.cuda.synchronize()
    log(f"[{tag}] engine built in {time.perf_counter() - t0:.2f}s, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB allocated "
        "at the peak so far")
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
        log(f"[{tag}] {per_step} limb-GEMM launches per serve_step" + (
            "" if cfg.family == "ssm" else
            f", bound {limb_gemm_step_bound_ms(cfg, 4):.4f} ms at 4 rows "
            "(their device time: the profile below)"))
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
            if solo_must_match:
                raise SystemExit(f"[{tag}] req {uid}: batched greedy tokens "
                                 "!= solo")
            first = next(i for i, (a, b) in enumerate(zip(solo,
                                                          batched[uid]))
                         if a != b)
            log(f"[{tag}] req {uid}: batched and solo tokens part at token "
                f"{first} (a finding, no limit): {BATCH_MATES[policy]}")
    profile_step(torch, lambda: eng._decode(
        np.zeros((4, 1), np.int32), 100,
        eng._mask([0, 1, 2, 3]))[0].sum().item(),
        f"one {policy} decode step (4 slots)")
    del eng
    torch.cuda.empty_cache()
    return launches


#: What makes a slot row's logits depend on its batch-mates under a
#: policy (phase 31 names it where batched and solo tokens differ).
BATCH_MATES = {
    "kom_int14": "the tied head's kom_q_dot quantizes the slot rows' "
                 "activations with one per-tensor scale, so a row's head "
                 "product depends on the other rows' max |x|",
    "native_bf16": "bf16 rounding that depends on the batch-mates"}


def family_embeds(torch, cfg, b: int) -> dict:
    """The batch entries beside the tokens that ``cfg``'s family reads,
    seeded, on the CPU: a VLM's ``img_embeds`` (b, n_img_tokens, d), an
    encoder-decoder's ``audio_embeds`` (b, enc_seq, d); none otherwise."""
    gen = torch.Generator().manual_seed(4)
    if cfg.family == "vlm":
        return {"img_embeds": torch.randn(
            (b, cfg.n_img_tokens, cfg.d_model), generator=gen)}
    if cfg.family == "encdec":
        return {"audio_embeds": torch.randn((b, cfg.enc_seq, cfg.d_model),
                                            generator=gen)}
    return {}


def phase_reduced_lm(torch, arch: str = "granite-3-2b") -> None:
    """Phases 13, 18, 22 and 27: reduced ``arch`` (all but the xLSTM with
    the flash kernel on; internvl2 with its image embeddings, whisper
    encoding its 16 frames, which fill one key block, before the decode)
    under fp32 and kom_int14 (f32 compute, weights quantized once as
    the engine does): the forward and four decode steps (hybrid: twelve,
    through a ring of 8 slots) on the card
    against the plain versions on the CPU (which the CPU tests hold against
    the JAX reference); for MoE every (token, layer) routed alike on both
    first; for the xLSTM also kom_int14 on float weights (both operands
    quantized per tensor, ``kom_q_dot``) within FLOAT_WEIGHTS_TOL, with
    the card's ``base_bits=6`` forward required to miss it."""
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
    to_card = lambda d: {k: v.cuda() for k, v in d.items()}
    for policy, tol, float_weights in cases:
        cfg = reduced(get_config(arch)).replace(
            policy=MatmulPolicy(policy), compute_dtype="float32",
            use_flash_kernel=arch != XLSTM)
        params = transformer.init_params(
            cfg, torch.Generator().manual_seed(2), device="cpu")
        if policy == "kom_int14" and not float_weights:
            params = quantize_params_inline(params)
        gp = transformer.params_to(params, "cuda")
        # MoE: the forward's tokens fill whole routing groups (64)
        seq = 32 if cfg.family == "moe" else 40
        tokens = torch.randint(0, cfg.vocab_size, (2, seq),
                               generator=torch.Generator().manual_seed(3))
        batch = {"tokens": tokens, **family_embeds(torch, cfg, 2)}
        what = policy + (" float weights" if float_weights else "")
        cpu_r, card_r = moe_routing(), moe_routing()
        with cpu_r:
            want, _ = transformer.forward(params, cfg, batch)
        build.reset_launches()
        with card_r:
            got, _ = transformer.forward(gp, cfg, to_card(batch))
        launches = build.launch_counts()
        rel = float((got.cpu() - want).abs().max() / want.abs().max())
        # hybrid: 12 steps through a ring of 8 (reduced window): it wraps
        n_dec, max_len = (12, 16) if cfg.family == "hybrid" else (4, 8)
        cache = transformer.init_cache(cfg, 2, max_len, device="cpu")
        gcache = transformer.init_cache(cfg, 2, max_len, device="cuda")
        if cfg.family == "encdec":
            cache = transformer.encode(params, cfg, batch["audio_embeds"],
                                       cache)
            gcache = transformer.encode(
                gp, cfg, batch["audio_embeds"].cuda(), gcache)
        drel = 0.0
        for t in range(n_dec):
            with cpu_r:
                w, cache = transformer.serve_step(params, cfg, cache,
                                                  tokens[:, t:t + 1], t)
            with card_r:
                g, gcache = transformer.serve_step(
                    gp, cfg, gcache, tokens[:, t:t + 1].cuda(), t)
            drel = max(drel, float((g.cpu() - w).abs().max()
                                   / w.abs().max()))
        if cfg.family == "moe":
            flips, total = routing_flips(card_r.seen, cpu_r.seen)
            log(f"[reduced_lm] {arch} (reduced) {what}: card vs CPU "
                f"routing: {flips} of {total} (token, layer) pairs differ "
                f"over the forward and {n_dec} decode steps")
            if flips or len(card_r.seen) != len(cpu_r.seen):
                raise SystemExit(f"[reduced_lm] {what}: routing differs "
                                 f"({flips} of {total})")
        miss = None
        if float_weights:
            with base_bits(6):
                bad, _ = transformer.forward(gp, cfg, to_card(batch))
            miss = float((bad.cpu() - want).abs().max() / want.abs().max())
        log(f"[reduced_lm] {arch} (reduced) {what}: card vs CPU "
            f"forward {rel:.3e}, {n_dec} decode steps {drel:.3e} (tol "
            f"{tol}), forward "
            f"launches {launches}"
            + ("" if miss is None else
               f"; base_bits=6 on the card {miss:.3e} away (must miss)"))
        want_l = {"flash_attention": flash_layers(cfg) + cfg.n_enc_layers} \
            if cfg.use_flash_kernel else {}
        if policy == "kom_int14":
            want_l["kom_matmul"] = limb_gemms_per_step(cfg)
        if launches != want_l or not (rel <= tol and drel <= tol) or \
                (miss is not None and not miss > tol):
            raise SystemExit(f"[reduced_lm] {what}: {rel}, {drel}, "
                             f"{launches}, control {miss}")

# ---------------------------------------------------------------------------
# Phases 19-22: the MoE family, full-width olmoe-1b-7b.
# ---------------------------------------------------------------------------

OLMOE = "olmoe-1b-7b"
MOE_MOD = "repro_torch.models.moe"
#: The profiled MoE ranges: routing, dispatch, the expert products and the
#: combine (the module-level functions of ``models/moe.py``).
MOE_RANGES = (("moe_route", "moe::route"), ("dispatch", "moe::dispatch"),
              ("experts", "moe::experts"), ("combine", "moe::combine"))


class moe_routing:
    """Inside the block (which may be entered again) ``models.moe.
    moe_route`` appends each call's outputs ``(probs, gate, idx, pos,
    keep)`` to ``seen``; with ``pin`` (a list of such outputs) it computes
    nothing and returns ``pin``'s entries in call order."""

    def __init__(self, pin=None):
        self.pin, self.seen = pin, []

    def __enter__(self):
        import importlib
        self.mod = importlib.import_module(MOE_MOD)
        self.orig = self.mod.moe_route

        def route(params, xg, cfg):
            out = self.orig(params, xg, cfg) if self.pin is None \
                else self.pin[len(self.seen)]
            self.seen.append(out)
            return out
        self.mod.moe_route = route
        return self

    def __exit__(self, *exc):
        self.mod.moe_route = self.orig


def routing_flips(got, want) -> tuple:
    """(the (token, layer) pairs whose chosen experts -- as a set -- or
    whose kept experts differ between two recorded routings, all pairs)."""
    flips = total = 0
    for a, b in zip(got, want):
        (ia, oa), (ib, ob) = a[2].cpu().sort(-1), b[2].cpu().sort(-1)
        ka, kb = a[4].cpu().gather(-1, oa), b[4].cpu().gather(-1, ob)
        flips += int(((ia != ib) | (ka != kb)).any(-1).sum())
        total += ia.shape[0] * ia.shape[1]
    return flips, total


def phase_compare_attention_olmoe(torch) -> None:
    """Phase 19: the flash-attention kernel at one full-width olmoe-1b-7b
    prefill layer (b 4, hq = hkv = 16, sq = skv = 2048, dh 128, causal) in
    f32 and bf16 against its plain version (mutant required to miss), timed
    beside SDPA (masked, and ``is_causal=True``) and the roofline bound
    (:func:`attention_case`); first the two dh-128 kernels' shared memory
    a block and what the compiler said of their registers and spills (when
    this process built the library)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.flash_attention import (
        _ARGTYPES, NAME)

    lib = build.library(NAME, _ARGTYPES)
    for label, dtype, bf16, mangled in (
            ("bf16", "bfloat16", 1, "flash_attention_ws_kernel"),
            ("f32", "float32", 0, "flash_attention_f32_kernelILi128E")):
        lines = [line for kernel, line in build.compiler_report(NAME)
                 if mangled in kernel]
        log(f"[attention] dh 128 {label} kernel: "
            f"{lib.flash_attention_smem_bytes(128, bf16)} bytes of dynamic "
            f"shared memory a block; ptxas: " + "; ".join(lines))
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((4, 16, 2048, 128), generator=gen,
                           device="cuda") for _ in range(3))
    attention_case(torch, build, {}, "olmoe prefill 4x2048", q, k, v)
    attention_case(torch, build, {}, "olmoe prefill 4x2048",
                   *(t.bfloat16() for t in (q, k, v)))


def phase_prefill_moe(torch, card: str, params) -> dict:
    """Phase 20: the olmoe-1b-7b prefill step (``use_flash_kernel=True``)
    on 4 x 2048 tokens under native_bf16 -- 16 flash launches, tokens/s, a
    profile with the MoE ranges -- then under fp32 (TF32 off): the
    plain-version forward with every layer's routing recorded, the kernel
    forward with ``moe_route`` pinned to it within PREFILL_TOL_FP32 of max
    |logit|, and an unpinned kernel forward whose flipped (token, layer)
    routings are counted (a finding, not a limit)."""
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.launch.step_fns import make_prefill_step

    cfg, batch, launches = prefill_bf16(
        torch, card, params, OLMOE,
        ranges=(tuple(label for _, label in MOE_RANGES),
                annotated((MOE_MOD, name, label)
                          for name, label in MOE_RANGES)))
    step32 = make_prefill_step(cfg.replace(policy=MatmulPolicy.FP32,
                                           compute_dtype="float32"))
    with build.plain_versions(), moe_routing() as plain:
        want = step32(params, batch)
    with moe_routing(pin=plain.seen):
        got = step32(params, batch)
    rel = float((got - want).abs().max() / want.abs().max())
    del got
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with moe_routing() as free:
        got = step32(params, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    free_rel = float((got - want).abs().max() / want.abs().max())
    flips, total = routing_flips(free.seen, plain.seen)
    log(f"[olmoe] fp32 (TF32 off), routing pinned to the plain-version "
        f"forward's: flash kernel vs plain-version forward max rel err "
        f"{rel:.3e} (tol {PREFILL_TOL_FP32})")
    log(f"[olmoe] fp32 unpinned: {flips} of {total} (token, layer) "
        f"routings differ from the plain-version forward's, logits "
        f"{free_rel:.3e} of max|logit| away (a finding, no limit); "
        f"{1e3 * dt:.1f} ms per 4x2048 prefill, {4 * 2048 / dt:.0f} "
        "tokens/s")
    if not rel <= PREFILL_TOL_FP32 or not torch.isfinite(got).all():
        raise SystemExit(f"[olmoe] fp32 logits off by {rel}")
    del got, want, plain, free
    torch.cuda.empty_cache()
    return launches


def phase_moe_ffn_card_vs_cpu(torch, params) -> None:
    """Phase 20b: one full-width olmoe-1b-7b MoE layer (layer 0's params:
    64 experts, top-8, groups of 512, capacity 84 per expert) on 4 x 2048
    random tokens in f32 (TF32 off), the card against the CPU.  Every
    (token, rank)'s expert must be equal, or a near tie on the CPU (the
    two experts' CPU probabilities within ROUTE_TIE_EPS: an ulp of the
    router's sum can swap them); where no token differs, pos and keep must
    be equal and y, aux within MOE_TOL_FFN_F32 / MOE_TOL_AUX.  Then, in
    any case, the card's ``moe_ffn`` with its routing pinned to the CPU's
    must be within those tolerances: the dispatch, the expert products and
    the combine at full-width buffer sizes (64 x 16 x 84 rows)."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer_params

    tag = f"moe_ffn {OLMOE} card vs CPU"
    cfg = get_config(OLMOE, policy=MatmulPolicy.FP32).replace(
        compute_dtype="float32")
    lp = layer_params(params["layers"], 0)["moe"]
    x = torch.randn((4, 2048, cfg.d_model),
                    generator=torch.Generator().manual_seed(7))
    with moe_routing() as card_r:
        y, aux = moe.moe_ffn(lp, x.cuda(), cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with moe_routing() as cpu_r:
        want, want_aux = moe.moe_ffn({k: v.cpu() for k, v in lp.items()},
                                     x, cfg)
    cpu_s = time.perf_counter() - t0
    probs, _, idx, pos, keep = cpu_r.seen[0]
    _, _, c_idx, c_pos, c_keep = (t.cpu() for t in card_r.seen[0])
    diff = c_idx != idx
    flipped = int(diff.any(-1).sum())
    gap = float((probs.gather(-1, c_idx) - probs.gather(-1, idx)).abs()
                .max())
    cap = moe.moe_capacity(idx.shape[1], cfg.moe_top_k,
                           cfg.moe_num_experts, cfg.moe_capacity_factor)
    log(f"[{tag}] {idx.shape[0]} groups of {idx.shape[1]}, capacity {cap}: "
        f"{int((~keep).sum())} of {keep.numel()} (token, slot) pairs "
        f"dropped on the CPU; {flipped} tokens routed differently, largest "
        f"CPU probability gap between the two sides' experts {gap:.3e} "
        f"(tie limit {ROUTE_TIE_EPS}); CPU layer {cpu_s:.2f}s")
    if gap > ROUTE_TIE_EPS:
        raise SystemExit(f"[{tag}] the card chose an expert the CPU does "
                         f"not tie with (gap {gap})")
    checks = []
    if not flipped:
        if not (torch.equal(c_pos, pos) and torch.equal(c_keep, keep)):
            raise SystemExit(f"[{tag}] same experts, different capacity "
                             "positions or drops")
        checks.append(("unpinned", y, aux))
    with moe_routing(pin=[tuple(t.cuda() for t in cpu_r.seen[0])]):
        checks.append(("routing pinned to the CPU's",)
                      + moe.moe_ffn(lp, x.cuda(), cfg))
    peak = float(want.abs().max())
    for what, got, got_aux in checks:
        rel = float((got.cpu() - want).abs().max()) / peak
        aux_rel = abs(float(got_aux) - float(want_aux)) / float(want_aux)
        log(f"[{tag}] {what}: y {rel:.3e} of max|y| (tol "
            f"{MOE_TOL_FFN_F32}), aux {float(got_aux):.6f} vs "
            f"{float(want_aux):.6f}, {aux_rel:.3e} (tol {MOE_TOL_AUX})")
        if not (rel <= MOE_TOL_FFN_F32 and aux_rel <= MOE_TOL_AUX
                and torch.isfinite(got).all()):
            raise SystemExit(f"[{tag}] {what}: y {rel}, aux {aux_rel}")
    del y, want, checks
    torch.cuda.empty_cache()


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
    from repro_torch.analysis.roofline import H100, mlstm_chunk_roofline
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
    issued_ms = 1e3 * 3 * rf["flops_issued"] / H100["peak_tf32"]
    log(f"[mlstm] mlstm_chunk {label} {str(q.dtype)[6:]}: max_abs_err="
        f"{err} ({err / scale:.3e} of max|plain| {scale:.4g}, tol "
        f"{MLSTM_TOL}) mutants {['%.3e' % m for m in misses]} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=null "
        f"bound_ms={b_ms:.4f} ({b_by}, {100 * b_ms / ms:.1f}%) "
        f"tf32x3_floor_ms={1e3 * rf['tf32x3_s']:.4f} "
        f"({100e3 * rf['tf32x3_s'] / ms:.1f}%; of what the kernels issue "
        f"{issued_ms:.4f}) scratch_mb={rf['scratch_bytes'] / 1e6:.1f}")
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
    hmma = build.sass_count("mlstm_chunk", "HMMA")
    log(f"[mlstm] TF32 mma.sync (HMMA) instructions in the mlstm_chunk "
        f"library's SASS: {hmma}")
    if not hmma:
        raise SystemExit("[mlstm] the mLSTM kernels issue no TF32 mma.sync")
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


class annotated:
    """Inside the block each ``(module, function name, label)`` of
    ``targets`` runs under ``record_function(label)`` (the profiled
    ranges of :func:`profile_step`)."""

    def __init__(self, targets):
        import importlib
        self.targets = [(importlib.import_module(m), name, label)
                        for m, name, label in targets]

    def __enter__(self):
        from torch.profiler import record_function

        def wrap(label, f):
            def wrapped(*a, **kw):
                with record_function(label):
                    return f(*a, **kw)
            return wrapped
        self.saved = [getattr(mod, name) for mod, name, _ in self.targets]
        for (mod, name, label), f in zip(self.targets, self.saved):
            setattr(mod, name, wrap(label, f))

    def __exit__(self, *exc):
        for (mod, name, _), f in zip(self.targets, self.saved):
            setattr(mod, name, f)


def _annotate_xlstm() -> annotated:
    """Each mLSTM chunk loop and each sLSTM block under
    ``record_function`` (labels :data:`XLSTM_RANGES`)."""
    return annotated(((SSM_MOD, "_mlstm_chunk_scan", XLSTM_RANGES[0]),
                      ("repro_torch.models.transformer", "slstm_block",
                       XLSTM_RANGES[1])))


#: The profiled xLSTM ranges: the mLSTM chunk loops and the sLSTM blocks
#: (their time loop and their two projections).
XLSTM_RANGES = ("xlstm::mlstm_chunk_loop", "xlstm::slstm_block")

# ---------------------------------------------------------------------------
# Phases 23-27: the VLM and encoder-decoder families, full-width
# internvl2-26b and whisper-large-v3.
# ---------------------------------------------------------------------------

INTERNVL = "internvl2-26b"
WHISPER = "whisper-large-v3"
#: internvl2-26b's params are 19.863 B: 79.5 GB in the config's f32, too
#: much for one 80 GB card with activations; 39.7 GB in bf16.
INTERNVL_KW = {"param_dtype": "bfloat16"}
#: Full-width internvl2 native_bf16 prefill, flash kernel against the
#: plain attention path (``use_flash_kernel=False``: the whole score
#: matrix, softmax in f32), of max |logit|: the CPU tests' native_bf16
#: limit (``tests/test_torch_lm.py`` TOL_BF16), a few bf16 ulps carried
#: through 48 layers.
PREFILL_TOL_BF16 = 3e-2
#: Full-width whisper decode against its teacher-forced forward, of max
#: |logit|: fp32 as PREFILL_TOL_FP32 (f32 sums in other orders through 64
#: layers); under native_bf16 and kom_int14 (both in bf16 compute) the
#: CPU tests' native_bf16 limit: a step's GEMMs (4 rows) round their bf16
#: outputs apart from the forward's (48 rows), an ulp now and then, and
#: kom_int14 also quantizes each step's activations per tensor apart.
#: The reference's reduced decode test holds elementwise rtol = atol =
#: 2e-2; at full width the 32 bf16 decoder layers miss that (1.29e-2 of
#: max |logit| under native_bf16, some logits off by more than 2e-2).
DECODE_TOL = {"fp32": 1e-4, "native_bf16": 3e-2, "kom_int14": 3e-2}


def phase_compare_attention_internvl(torch) -> None:
    """Phase 23: the flash-attention kernel at one full-width internvl2-26b
    prefill layer (b 4, hq 48, hkv 8: six q heads a kv head, sq = skv =
    2048, dh 128, causal) in f32 and bf16 against its plain version, as
    phase 19 (:func:`attention_case`: tolerances, bf16 row by row, the
    mutants, SDPA masked and ``is_causal=True``, the bound)."""
    from repro_torch.kernels import build

    gen = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn((4, 48, 2048, 128), generator=gen, device="cuda")
    k, v = (torch.randn((4, 8, 2048, 128), generator=gen, device="cuda")
            for _ in range(2))
    attention_case(torch, build, {}, "internvl2 prefill 4x2048", q, k, v)
    attention_case(torch, build, {}, "internvl2 prefill 4x2048",
                   *(t.bfloat16() for t in (q, k, v)))


def phase_prefill_internvl(torch, card: str, params) -> dict:
    """Phase 24: the internvl2-26b prefill step (``use_flash_kernel=True``,
    bf16 params) on 4 x 2048 tokens with seeded ``img_embeds`` (4, 256,
    6144) under native_bf16: 48 flash launches, tokens/s, a profile; the
    logits within PREFILL_TOL_BF16 of the same step on the plain attention
    path, and under fp32 (one sequence) within PREFILL_TOL_FP32; other
    token ids at the 256 image positions give the same logits bit for bit
    (the image embeddings replace them)."""
    import numpy as np

    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.launch.step_fns import make_prefill_step

    gen = torch.Generator(device="cuda").manual_seed(6)
    img = torch.randn((4, 256, 6144), generator=gen, device="cuda")
    cfg, batch, launches = prefill_bf16(
        torch, card, params, INTERNVL, embeds={"img_embeds": img},
        **INTERNVL_KW)
    step = make_prefill_step(cfg)
    got = step(params, batch)
    want = make_prefill_step(cfg.replace(use_flash_kernel=False))(params,
                                                                  batch)
    rel = float((got - want).abs().max() / want.abs().max())
    del want
    log(f"[internvl2] native_bf16: flash kernel vs the plain attention path "
        f"max rel err {rel:.3e} of max|logit| (tol {PREFILL_TOL_BF16})")
    # fp32 (TF32 off) on one sequence: the f32 kernel against the same
    # plain path, where rounding cannot hide a fault
    one = {k: v[:1] for k, v in batch.items()}
    f32 = cfg.replace(policy=MatmulPolicy.FP32, compute_dtype="float32")
    got32 = make_prefill_step(f32)(params, one)
    want32 = make_prefill_step(f32.replace(use_flash_kernel=False))(params,
                                                                    one)
    rel32 = float((got32 - want32).abs().max() / want32.abs().max())
    del got32, want32
    log(f"[internvl2] fp32 (TF32 off), 1 x 2048 tokens: flash kernel vs "
        f"the plain attention path max rel err {rel32:.3e} of max|logit| "
        f"(tol {PREFILL_TOL_FP32})")
    tokens = batch["tokens"].clone()
    tokens[:, :cfg.n_img_tokens] = torch.from_numpy(
        np.random.default_rng(1).integers(
            0, cfg.vocab_size, (4, cfg.n_img_tokens))).cuda()
    same = torch.equal(step(params, dict(batch, tokens=tokens)), got)
    log(f"[internvl2] other token ids at the {cfg.n_img_tokens} image "
        f"positions: logits bit for bit the same: {same}")
    if not (rel <= PREFILL_TOL_BF16 and rel32 <= PREFILL_TOL_FP32
            and same):
        raise SystemExit(f"[internvl2] prefill: kernel vs plain {rel} "
                         f"(fp32 {rel32}), image positions ignored {same}")
    del got, batch
    torch.cuda.empty_cache()
    return launches


def phase_compare_whisper_gemm(torch) -> None:
    """Phase 26a: the limb GEMM at whisper-large-v3's encoder shapes (m =
    4 x 1500 rows; q/k/v/o d x d, up d x d_ff, down d_ff x d) with row and
    column scales and a bias, as ``kom_q_dot`` calls it under kom_int14:
    exact against its plain version, timed beside its three int8 passes
    through ``torch._int_mm`` and the bound; the sums over one encoder
    forward weight each shape by its count."""
    from repro_torch.configs import get_config
    from repro_torch.core.substrate import kom_qmax
    from repro_torch.kernels import build
    from repro_torch.kernels.kom_matmul import kom_matmul_int, kom_split_k

    cfg = get_config(WHISPER)
    d, d_ff, n_enc = cfg.d_model, cfg.d_ff, cfg.n_enc_layers
    gen = torch.Generator().manual_seed(8)
    qmax, m = kom_qmax(7), 4 * cfg.enc_seq
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for label, (k, n), count in (("q/k/v/o", (d, d), 4 * n_enc),
                                 ("up", (d, d_ff), n_enc),
                                 ("down", (d_ff, d), n_enc)):
        a = torch.randint(-qmax, qmax + 1, (m, k), generator=gen).to(
            torch.int16).cuda()
        b = torch.randint(-qmax, qmax + 1, (k, n), generator=gen).to(
            torch.int16).cuda()
        rs = (torch.rand(m, generator=gen) * 1e-3 + 1e-4).cuda()
        cs = (torch.rand(n, generator=gen) * 1e-3 + 1e-4).cuda()
        bias = torch.randn(n, generator=gen).cuda()
        run = lambda a=a, b=b, rs=rs, cs=cs, bias=bias: kom_matmul_int(
            a, b, variant="karatsuba", base_bits=7, row_scale=rs,
            col_scale=cs, bias=bias)
        ops, nbytes = limb_gemm_work(m, k, n)
        nbytes += 4 * n
        plan = kom_split_k(m, k, n)
        log(f"[compare] kom_matmul {WHISPER} encoder {label} ({k}x{n}) "
            f"m={m} + bias: split {plan['splits']} x {plan['group_k']} K "
            f"entries, {plan['m_tile']}-row tile, {plan['blocks']} blocks")
        lib_ms = int_mm_passes_ms(torch, a, b, "karatsuba", 7)
        _, ms, plain_ms = compare_call(
            torch, build, "kom_int14", "kom_matmul", f"whisper {label}",
            run, ops, nbytes, lib_ms)
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms),
                       ("bound_ms", bound_ms(ops, nbytes, "int8")[0])):
            tot[key] = None if v is None or tot[key] is None \
                else tot[key] + count * v
    log(f"[compare] kom_matmul per {WHISPER} encoder forward "
        f"({6 * n_enc} calls, m = {m}): "
        + ", ".join(f"{k} {v if v is None else round(v, 4)}"
                    for k, v in tot.items()))


def phase_whisper(torch, card: str, params) -> dict:
    """Phase 26b: whisper-large-v3 (f32 params, ``use_flash_kernel=False``:
    the encoder's 1500 frames fill no 128-key block, and a non-causal
    flash call refuses them in both packages) under native_bf16, fp32 (TF32
    off) and kom_int14.  The prefill step on seeded ``audio_embeds`` (4,
    1500, 1280) and 4 x 448 decoder tokens: finite logits, tokens/s, under
    kom_int14 513 limb-GEMM launches a forward and the logits equal to
    the plain-version forward's bit for bit (native_bf16: a profile).
    Then ``encode`` (256 limb GEMMs under kom_int14) and 12 greedy
    ``make_serve_step`` steps at batch 4 (257 a step), held against the
    teacher-forced forward of the tokens they were fed (DECODE_TOL)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.launch.step_fns import (make_prefill_step,
                                             make_serve_step)
    from repro_torch.models import transformer

    gen = torch.Generator(device="cuda").manual_seed(9)
    audio = torch.randn((4, 1500, 1280), generator=gen, device="cuda")
    launches = {}
    for policy in ("native_bf16", "fp32", "kom_int14"):
        tag = f"{WHISPER} {policy}"
        cfg = get_config(WHISPER, policy=MatmulPolicy(policy))
        if policy == "fp32":
            cfg = cfg.replace(compute_dtype="float32")
        counts = encdec_limb_gemms(cfg)
        kom = policy == "kom_int14"
        tokens = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (4, 448)).astype(np.int64)).cuda()
        batch = {"tokens": tokens, "audio_embeds": audio}
        step = make_prefill_step(cfg)
        step(params, batch)
        torch.cuda.synchronize()
        build.reset_launches()
        logits = step(params, batch)
        torch.cuda.synchronize()
        got = build.launch_counts()
        check_launches(f"prefill {tag}", got,
                       {"kom_matmul": counts["forward"]} if kom else {})
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        if logits.shape != (4, 448, cfg.padded_vocab) or \
                not torch.isfinite(logits).all():
            raise SystemExit(f"[{tag}] bad logits {tuple(logits.shape)}")
        if kom:
            with build.plain_versions():
                plain = step(params, batch)
            err = float((logits - plain).abs().max())
            same = torch.equal(logits, plain)
            log(f"[{tag}] prefill: limb kernel vs plain-version forward "
                f"max abs err {err} (bit for bit: {same})")
            if not same:
                raise SystemExit(f"[{tag}] kernel forward != plain ({err})")
            del plain
        del logits
        n_it = 3
        t0 = time.perf_counter()
        for _ in range(n_it):
            step(params, batch)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n_it
        log(f"[prefill] {tag} on {card}: {1e3 * dt:.1f} ms per prefill of "
            f"4 x 1500 frames + 4 x 448 tokens ({4 * 448 / dt:.0f} decoder "
            f"tokens/s, {4 * 1500 / dt:.0f} frames/s)")
        if policy == "native_bf16":
            profile_step(torch, lambda: step(params, batch).sum().item(),
                         f"one {WHISPER} native_bf16 prefill step")
        # encode, then 12 greedy decode steps
        serve = make_serve_step(cfg)
        build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = transformer.encode(
            params, cfg, audio, transformer.init_cache(cfg, 4, 16,
                                                       device="cuda"))
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        enc_launches = build.launch_counts()
        tok, fed, outs = tokens[:, :1], [], []
        t0 = time.perf_counter()
        for t in range(12):
            fed.append(tok)
            lg, cache = serve(params, cache, tok, t)
            outs.append(lg[:, 0])
            tok = lg[:, 0, :cfg.vocab_size].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        dec_s = (time.perf_counter() - t0) / 12
        dec_launches = build.launch_counts()
        if kom:
            check_launches(f"encode {tag}", enc_launches,
                           {"kom_matmul": counts["encode"]})
            check_launches(f"decode {tag}", dec_launches, {
                "kom_matmul": counts["encode"] + 12 * counts["step"]})
        for name, n in dec_launches.items():
            launches[name] = launches.get(name, 0) + n
        dec = torch.stack(outs, 1)
        tf = step(params, {"tokens": torch.cat(fed, 1),
                           "audio_embeds": audio})
        d = (dec - tf).abs()
        rel = float(d.max() / tf.abs().max())
        log(f"[decode] {tag} on {card}: encode {1e3 * enc_s:.1f} ms, "
            f"{1e3 * dec_s:.1f} ms a decode step at batch 4 "
            f"({4 / dec_s:.1f} tokens/s); decode vs the teacher-forced "
            f"forward max rel err {rel:.3e} of max|logit| (tol "
            f"{DECODE_TOL[policy]}; max abs {float(d.max()):.3e}, "
            f"max|logit| {float(tf.abs().max()):.3f}), greedy tokens "
            f"{[int(t) for t in torch.cat(fed, 1)[0, 1:]]}")
        if not rel <= DECODE_TOL[policy] or not torch.isfinite(dec).all():
            raise SystemExit(f"[{tag}] decode != forward ({rel})")
        del dec, tf, cache, outs
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phases 28-32: the hybrid family, full-width recurrentgemma-9b.
# ---------------------------------------------------------------------------

RGEMMA = "recurrentgemma-9b"
#: One attention block's ring decode against plain attention over the
#: explicit last ``local_window`` positions, in f32, of max |out|: the same
#: keys in slot order against position order (sums in another order).
RING_TOL = 1e-5


def phase_compare_attention_rgemma(torch) -> None:
    """Phase 28: the flash-attention kernel at recurrentgemma-9b's
    attention layer (hq 16, hkv 1: MQA 16:1, dh 256, causal, window 2048)
    in f32 and bf16 against its plain version, as phase 19
    (:func:`attention_case`: tolerances, bf16 row by row with a skipped
    middle 32-key tile required to miss, the strict-causal mutant, SDPA
    masked and ``is_causal=True``, the bound): at b 4 x 2048 (the window
    cuts nothing) and at 1 x 8192 (it cuts every row past 2047); first the
    dh-256 kernels' shared memory a block and what the compiler said of
    their registers and spills (when this process built the library)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.flash_attention import (
        _ARGTYPES, NAME)

    lib = build.library(NAME, _ARGTYPES)
    for label, bf16, mangled in (
            ("bf16", 1, "flash_attention_tc_kernelILi256E"),
            ("f32", 0, "flash_attention_f32_kernelILi256E")):
        lines = [line for kernel, line in build.compiler_report(NAME)
                 if mangled in kernel]
        log(f"[attention] dh 256 {label} kernel: "
            f"{lib.flash_attention_smem_bytes(256, bf16)} bytes of dynamic "
            f"shared memory a block; ptxas: " + "; ".join(lines))
    gen = torch.Generator(device="cuda").manual_seed(3)
    for b, s in ((4, 2048), (1, 8192)):
        q = torch.randn((b, 16, s, 256), generator=gen, device="cuda")
        k, v = (torch.randn((b, 1, s, 256), generator=gen, device="cuda")
                for _ in range(2))
        label = f"recurrentgemma {b}x{s} window 2048"
        attention_case(torch, build, {}, label, q, k, v, window=2048)
        attention_case(torch, build, {}, label,
                       *(t.bfloat16() for t in (q, k, v)), window=2048)
        del q, k, v


def phase_prefill_rgemma(torch, card: str, params) -> dict:
    """Phase 29: the recurrentgemma-9b prefill step
    (``use_flash_kernel=True``) on 4 x 2048 tokens under native_bf16: 12
    flash launches (the attention blocks), tokens/s and a profile with
    each RG-LRU associative scan as its own range; its logits within
    PREFILL_TOL_BF16 of the same step on the plain attention path; then
    under fp32 (TF32 off) the kernel forward within PREFILL_TOL_FP32 of the
    plain attention path's, timed."""
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.launch.step_fns import make_prefill_step

    cfg, batch, launches = prefill_bf16(
        torch, card, params, RGEMMA,
        ranges=(("rglru::scan",),
                annotated(((SSM_MOD, "_rglru_scan", "rglru::scan"),))))
    for c in (cfg, cfg.replace(policy=MatmulPolicy.FP32,
                               compute_dtype="float32")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = make_prefill_step(c)(params, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = make_prefill_step(c.replace(use_flash_kernel=False))(params,
                                                                    batch)
        rel = float(max((g - w).abs().max() for g, w in zip(got, want))
                    / want.abs().max())
        del got, want
        torch.cuda.empty_cache()
        tol = PREFILL_TOL_FP32 if c.compute_dtype == "float32" \
            else PREFILL_TOL_BF16
        log(f"[recurrentgemma] {c.policy.value}: flash kernel vs the plain "
            f"attention path max rel err {rel:.3e} of max|logit| (tol "
            f"{tol}); the kernel forward {1e3 * dt:.1f} ms per 4x2048 "
            f"prefill, {4 * 2048 / dt:.0f} tokens/s on {card}")
        if not rel <= tol:
            raise SystemExit(f"[recurrentgemma] {c.policy.value} prefill: "
                             f"kernel vs plain {rel}")
    del batch
    torch.cuda.empty_cache()
    return launches


def phase_ring_decode(torch, card: str, params) -> dict:
    """Phase 30: decode at full width under fp32.  One attention block's
    ``_ring_local_attention`` (the first group's, b 4) from a ring of 2048
    slots pre-filled with seeded K/V, at pos 2047 (full, not wrapped),
    2048 (slot 0 overwritten) and 5000 (wrapped twice): within RING_TOL
    of max |out| of plain attention over the explicit last 2048 positions
    (the ring's slots gathered in position order, the same q).  Then 16
    teacher-forced ``serve_step`` s at batch 4 against the fp32 forward
    (flash kernel on) within DECODE_TOL: no flash launches in decode."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.kernels import build
    from repro_torch.models import transformer
    from repro_torch.models.attention import KVCache, dot_attention_torch
    from repro_torch.models.layers import dense, rope

    cfg = get_config(RGEMMA, policy=MatmulPolicy.FP32,
                     compute_dtype="float32", use_flash_kernel=True)
    lp = transformer.layer_params(params["groups"]["b2"], 0)["mixer"]
    w, hkv, dh = cfg.local_window, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(7)
    ring = KVCache(*(torch.randn((4, hkv, w, dh), generator=gen,
                                 device="cuda") for _ in range(2)))
    x = torch.randn((4, 1, cfg.d_model), generator=gen, device="cuda")
    worst = 0.0
    for pos in (w - 1, w, 5000):
        with torch.inference_mode():
            y, new = transformer._ring_local_attention(lp, x, cfg, ring, pos,
                                                       w)
            p = torch.arange(max(0, pos - w + 1), pos + 1, device="cuda")
            k, v = (t[:, :, p % w] for t in new)
            q = rope(dense(x, lp["wq"], policy=cfg.policy).reshape(
                4, 1, cfg.n_heads, dh), torch.tensor([pos], device="cuda"),
                theta=cfg.rope_theta).transpose(1, 2)
            o = dot_attention_torch(q, k, v, causal=False, window=None,
                                    q_offset=pos)
            want = dense(o.transpose(1, 2).reshape(4, 1, -1), lp["wo"],
                         policy=cfg.policy)
        rel = float((y - want).abs().max() / want.abs().max())
        kept = [i for i in range(w) if i != pos % w]
        same = all(torch.equal(a[:, :, kept], b[:, :, kept])
                   for a, b in zip(new, ring))
        log(f"[ring] recurrentgemma attention block, b 4, ring of {w}, pos "
            f"{pos} (slot {pos % w}): vs plain attention over positions "
            f"{int(p[0])}..{pos} max rel err {rel:.3e} (tol {RING_TOL}); "
            f"the other {w - 1} slots bit for bit: {same}")
        worst = max(worst, rel)
        if not (rel <= RING_TOL and same):
            raise SystemExit(f"[ring] pos {pos}: {rel}, slots kept {same}")
    del ring, new
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int64)).cuda()
    tf, _ = transformer.forward(params, cfg, {"tokens": tokens})
    cache = transformer.init_cache(cfg, 4, 16, device="cuda")
    build.reset_launches()
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(16):
        lg, cache = transformer.serve_step(params, cfg, cache,
                                           tokens[:, t:t + 1], t)
        outs.append(lg[:, 0])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 16
    launches = build.launch_counts()
    dec = torch.stack(outs, 1)
    rel = float((dec - tf).abs().max() / tf.abs().max())
    log(f"[decode] recurrentgemma fp32 on {card}: {1e3 * dt:.1f} ms a "
        f"serve_step at batch 4 ({4 / dt:.1f} tokens/s); 16 steps vs the "
        f"teacher-forced forward max rel err {rel:.3e} of max|logit| (tol "
        f"{DECODE_TOL['fp32']}), launches {launches}")
    if not rel <= DECODE_TOL["fp32"] or launches or \
            not torch.isfinite(dec).all():
        raise SystemExit(f"[decode] recurrentgemma: decode != forward "
                         f"({rel}), launches {launches}")
    del tf, dec, outs, cache
    torch.cuda.empty_cache()
    return launches


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
        for kernel, line in build.compiler_report(name):
            log(f"[build] {name}: {kernel} {line}")
    phase_sass_int()
    summary = phase_compare(torch)
    summary.update(phase_compare_fused(torch))
    summary.update(phase_compare_systolic_float(torch))
    launches = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    phase_plan(torch, card)
    counts, alex = phase_serve(torch, card)
    add(counts)
    counts, vgg = phase_serve_vgg16(torch, card)
    add(counts)
    t0 = time.perf_counter()
    add(phase_chaos(torch, card, alex))
    add(phase_oom(torch, card, alex))
    add(phase_dispatch(torch, card, alex, vgg))
    add(phase_launcher(torch, card))
    log(f"[faults] phases 6c-6f took {time.perf_counter() - t0:.1f}s")
    del alex, vgg
    torch.cuda.empty_cache()
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
    t0 = time.perf_counter()
    phase_compare_attention_olmoe(torch)
    olmoe = lm_params(torch, OLMOE)
    add(phase_prefill_moe(torch, card, olmoe))
    phase_moe_ffn_card_vs_cpu(torch, olmoe)
    phase_compare_lm_gemm(torch, OLMOE)
    for policy in ("native_bf16", "kom_int14"):
        add(phase_serve_lm(torch, card, olmoe, policy, OLMOE))
    del olmoe
    torch.cuda.empty_cache()
    phase_reduced_lm(torch, OLMOE)
    log(f"[moe] phases 19-22 took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_compare_attention_internvl(torch)
    internvl = lm_params(torch, INTERNVL, **INTERNVL_KW)
    add(phase_prefill_internvl(torch, card, internvl))
    add(phase_serve_lm(torch, card, internvl, "native_bf16", INTERNVL,
                       **INTERNVL_KW))
    # the bf16 tree and its QWeights do not fit side by side: the engine
    # quantizes the tree in place, its last use
    torch.cuda.reset_peak_memory_stats()
    add(phase_serve_lm(torch, card, internvl, "kom_int14", INTERNVL,
                       donate=True, **INTERNVL_KW))
    del internvl
    torch.cuda.empty_cache()
    phase_compare_whisper_gemm(torch)
    whisper = lm_params(torch, WHISPER)
    add(phase_whisper(torch, card, whisper))
    del whisper
    torch.cuda.empty_cache()
    for arch in (INTERNVL, WHISPER):
        phase_reduced_lm(torch, arch)
    log(f"[vlm/encdec] phases 23-27 took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_compare_attention_rgemma(torch)
    rgemma = lm_params(torch, RGEMMA)
    add(phase_prefill_rgemma(torch, card, rgemma))
    add(phase_ring_decode(torch, card, rgemma))
    phase_compare_lm_gemm(torch, RGEMMA)
    add(phase_serve_lm(torch, card, rgemma, "fp32", RGEMMA,
                       compute_dtype="float32"))
    for policy in ("native_bf16", "kom_int14"):
        add(phase_serve_lm(torch, card, rgemma, policy, RGEMMA,
                           solo_must_match=False))
    del rgemma
    torch.cuda.empty_cache()
    phase_reduced_lm(torch, RGEMMA)
    log(f"[hybrid] phases 28-32 took {time.perf_counter() - t0:.1f}s")
    kernels = []
    for name in KERNELS:
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "raw_product_ms": s.get("raw_product_ms")})
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
