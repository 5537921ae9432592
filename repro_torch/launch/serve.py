"""Serving launcher: batched image requests or LM requests through the port.

    python -m repro_torch.launch.serve --arch alexnet --policy kom_int14 \\
        --buckets 1,4,16 --requests 32 [--device cpu] [--reduced]
    python -m repro_torch.launch.serve --arch vgg16 --policy kom_int14 \\
        --explore --model-only --requant
    python -m repro_torch.launch.serve --arch vgg16 --policy kom_int14 \\
        --conv-path systolic
    python -m repro_torch.launch.serve --arch vgg16 --policy bf16x3 \\
        --conv-path implicit
    python -m repro_torch.launch.serve --arch granite-3-2b \\
        --policy kom_int14 --slots 4 --requests 8
    python -m repro_torch.launch.serve --arch xlstm-125m \\
        --policy kom_int14 --slots 4 --requests 8

Runs on the GPU unless ``--device cpu`` is given (and refuses to start
without one otherwise).  ``--reduced`` serves the CPU-test twin of the
config (tiny widths); without it the model is served at full width (the
reference's LM launcher cannot turn its ``--reduced`` off; the port keeps
one rule for both halves).

CNNs: without ``--plan``/``--explore`` the engine resolves its plan
(the committed ``repro_torch/tuned/plans/<backend>.json``, else the
heuristic; the committed ``cuda.json`` ranks engines by batch-1 walls
that host overhead dominates, see ``PERF.md``).  ``--tune`` sweeps the
implicit engine's Cin chunk on the device first.  ``--explore`` plans every conv layer at launch by timing the
candidate engines on the device (measured; ``--model-only`` ranks by the
port's cost model instead, ``--requant`` allows the ``pool_quant``
handoff); ``--plan PATH`` serves a saved plan artifact.  ``--conv-path``
pins ONE engine for every conv layer instead (it refuses ``--plan`` and
``--explore``, and a policy the engine cannot run exactly, as the
reference launcher does).

LMs (the dense and xLSTM families): ``--slots`` decode slots,
``--max-len`` cache length, ``--max-new`` tokens per request; each
request's prompt is ``rng.integers(3, 9)`` random tokens, as in the
reference.  ``--policy``
defaults to the config's own (``native_bf16``) for an LM and to
``kom_int14`` for a CNN.  The multi-model dispatcher and fault injection
of the reference launcher are not ported yet.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, CNN_ARCHS, get_config, reduced
from repro_torch.core.precision import MatmulPolicy
from repro_torch.core.substrate import validate_path_policy
from repro_torch.device import resolve_device


def _cnn_plan(cfg, args, device):
    """The ExecutionPlan the flags ask for, or None (the engine's chain).

    ``--explore`` runs the port's explorer for this config at launch
    (measured on ``device`` unless ``--model-only``); ``--plan PATH``
    serves a saved artifact for this device type; neither leaves the
    plan to the engine's resolution chain.
    """
    from repro_torch.core.planner import explore, load_plans, plan_key

    if args.explore:
        plan = explore(cfg, model_only=args.model_only, backend=device.type,
                       requant=args.requant, device=device)
    elif args.plan:
        plans = load_plans(args.plan, backend=device.type)
        key = plan_key(cfg.name, cfg.policy)
        if key not in plans:
            raise SystemExit(f"--plan {args.plan}: no plan for {key!r} "
                             f"(has {sorted(plans)})")
        plan = plans[key]
    else:
        return None
    for e in plan.entries:
        print(f"[serve] plan {e.key}: {e.path} block="
              f"{list(e.block) if e.block else '-'} fusion={e.fusion} "
              f"est_us={e.est_us} ({e.source})")
    return plan


def serve_cnn(cfg, args) -> int:
    from repro_torch.models.cnn import cnn_init
    from repro_torch.serving.cnn_engine import CNNServeEngine, ImageRequest

    device = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    params = cnn_init(cfg, gen, device=device)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    engine = CNNServeEngine(cfg, params, buckets=buckets, device=device,
                            plan=_cnn_plan(cfg, args, device),
                            tune=args.tune)
    engine.warmup()
    rng = np.random.default_rng(args.seed)
    h, c = cfg.img_size, cfg.in_channels
    t0 = time.time()
    for uid in range(args.requests):
        img = rng.standard_normal((h, h, c)).astype(np.float32)
        engine.submit(ImageRequest(uid=uid, image=img))
    done = engine.run()
    dt = time.time() - t0
    s = engine.stats()
    for uid in sorted(done):
        lat = engine.batcher.queue.latency(uid)
        print(f"[serve] img {uid}: label {done[uid].label} "
              f"({1e3 * lat:.1f} ms)")
    for uid, flr in sorted(engine.failed.items()):
        print(f"[serve] img {uid}: FAILED after {flr.attempts} attempts "
              f"({flr.error})")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[serve] {cfg.name}/{cfg.policy.value}/{cfg.conv_path} on {where}: "
          f"{s['images_done']} images in {dt:.2f}s wall "
          f"({s['images_per_s']:.1f} img/s batched, "
          f"p50 latency {1e3 * s['latency_p50_s']:.1f} ms, "
          f"p95 latency {1e3 * s['latency_p95_s']:.1f} ms, "
          f"padding {100 * s['padding_fraction']:.0f}%, "
          f"failed {s['requests_failed']}, health {s['health']}, "
          f"buckets {s['bucket_counts']})", flush=True)
    served = len(done) + len(engine.expired) + len(engine.failed)
    return 0 if served == args.requests else 1


def serve_lm(cfg, args) -> int:
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Request, ServeEngine

    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = transformer.init_params(cfg, gen, device=device)
    engine = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                         device=device)
    del params
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for uid in range(args.requests):
        plen = int(rng.integers(3, 9))
        prompt = rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt,
                              max_new_tokens=args.max_new))
    done = engine.run()
    dt = time.time() - t0
    n_tok = sum(len(r.out_tokens) for r in done.values())
    for uid in sorted(done):
        r = done[uid]
        print(f"[serve] req {uid}: prompt {[int(t) for t in r.prompt]} -> "
              f"{r.out_tokens}")
    for uid in sorted(engine.expired):
        print(f"[serve] req {uid}: EXPIRED before admission")
    for uid, flr in sorted(engine.failed.items()):
        print(f"[serve] req {uid}: FAILED after {flr.attempts} attempts "
              f"({flr.error})")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[serve] {cfg.name}/{cfg.policy.value} on {where}: {len(done)} "
          f"requests ({len(engine.expired)} expired, {len(engine.failed)} "
          f"failed, health {engine.health}), {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / dt:.1f} tok/s)", flush=True)
    served = len(done) + len(engine.expired) + len(engine.failed)
    return 0 if served == args.requests else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="alexnet", choices=CNN_ARCHS + ARCHS)
    ap.add_argument("--policy", default=None,
                    choices=[p.value for p in MatmulPolicy],
                    help="default: kom_int14 for a CNN, the config's own "
                         "for an LM")
    ap.add_argument("--buckets", default="1,4,16",
                    help="microbatch bucket sizes (comma-separated)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the tiny-width twin of the config")
    ap.add_argument("--conv-path", default="auto",
                    choices=("auto", "im2col", "systolic", "implicit",
                             "winograd"),
                    help="pin one conv engine for every layer (default: "
                         "the plan chain)")
    ap.add_argument("--plan", default=None,
                    help="serve a saved ExecutionPlan artifact "
                         "(repro_torch/tuned/plans/<backend>.json)")
    ap.add_argument("--explore", action="store_true",
                    help="plan every conv layer with the explorer at launch")
    ap.add_argument("--model-only", action="store_true",
                    help="with --explore: rank by the H100 roofline cost "
                         "model instead of timing the engines")
    ap.add_argument("--requant", action="store_true",
                    help="with --explore: allow the pool_quant handoff "
                         "(the next layer reads the producer's int16)")
    ap.add_argument("--tune", action="store_true",
                    help="sweep the implicit engine's Cin chunk of every "
                         "conv layer on the device first (into "
                         "repro_torch/tuned/measured.local.json)")
    ap.add_argument("--slots", type=int, default=4,
                    help="LM: decode slots")
    ap.add_argument("--max-new", type=int, default=12,
                    help="LM: new tokens per request")
    ap.add_argument("--max-len", type=int, default=128,
                    help="LM: KV cache length per slot")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.arch in ARCHS:
        cnn_only = [f for f, on in (
            ("--explore", args.explore), ("--plan", args.plan),
            ("--model-only", args.model_only), ("--requant", args.requant),
            ("--tune", args.tune),
            ("--conv-path", args.conv_path != "auto")) if on]
        if cnn_only:
            ap.error(f"{', '.join(cnn_only)}: CNN flags; {args.arch} is an "
                     "LM")
        cfg = get_config(args.arch)
        if args.policy:
            cfg = cfg.replace(policy=MatmulPolicy(args.policy))
        if args.reduced:
            cfg = reduced(cfg)
        return serve_lm(cfg, args)
    args.policy = args.policy or "kom_int14"
    if args.explore and args.plan:
        ap.error("--explore and --plan are mutually exclusive")
    if (args.model_only or args.requant) and not args.explore:
        ap.error("--model-only and --requant go with --explore")
    cfg = get_config(args.arch, policy=MatmulPolicy(args.policy),
                     conv_path=args.conv_path)
    if cfg.conv_path != "auto" and (args.plan or args.explore):
        ap.error(f"--conv-path {cfg.conv_path} pins ONE engine for every "
                 "layer; --plan/--explore choose per layer -- drop one")
    try:
        validate_path_policy(cfg.conv_path, cfg.policy)
    except ValueError as e:
        ap.error(f"--conv-path {e}")
    if args.reduced:
        cfg = reduced(cfg)
    return serve_cnn(cfg, args)


if __name__ == "__main__":
    sys.exit(main())
