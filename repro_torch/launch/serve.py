"""Serving launcher, CNN half: batched image requests through the port.

    python -m repro_torch.launch.serve --arch alexnet --policy kom_int14 \\
        --buckets 1,4,16 --requests 32 [--device cpu] [--reduced]

Runs on the GPU unless ``--device cpu`` is given (and refuses to start
without one otherwise).  ``--reduced`` serves the CPU-test twin of the
config (tiny widths); without it the model is served at full width.  The
transformer archs, the multi-model dispatcher, fault injection and the
plan explorer of the reference launcher are not ported yet.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import CNN_ARCHS, get_config, reduced
from repro_torch.core.precision import MatmulPolicy
from repro_torch.device import resolve_device


def serve_cnn(cfg, args) -> int:
    from repro_torch.models.cnn import cnn_init
    from repro_torch.serving.cnn_engine import CNNServeEngine, ImageRequest

    device = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    params = cnn_init(cfg, gen, device=device)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    engine = CNNServeEngine(cfg, params, buckets=buckets, device=device)
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
    print(f"[serve] {cfg.name}/{cfg.policy.value} on {where}: "
          f"{s['images_done']} images in {dt:.2f}s wall "
          f"({s['images_per_s']:.1f} img/s batched, "
          f"p50 latency {1e3 * s['latency_p50_s']:.1f} ms, "
          f"p95 latency {1e3 * s['latency_p95_s']:.1f} ms, "
          f"padding {100 * s['padding_fraction']:.0f}%, "
          f"failed {s['requests_failed']}, health {s['health']}, "
          f"buckets {s['bucket_counts']})", flush=True)
    served = len(done) + len(engine.expired) + len(engine.failed)
    return 0 if served == args.requests else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="alexnet", choices=CNN_ARCHS)
    ap.add_argument("--policy", default="kom_int14",
                    choices=[p.value for p in MatmulPolicy])
    ap.add_argument("--buckets", default="1,4,16",
                    help="microbatch bucket sizes (comma-separated)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the tiny-width twin of the config")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, policy=MatmulPolicy(args.policy))
    if args.reduced:
        cfg = reduced(cfg)
    return serve_cnn(cfg, args)


if __name__ == "__main__":
    sys.exit(main())
