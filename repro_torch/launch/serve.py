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
    python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
        --policy kom_int14 --slots 4 --requests 8
    python -m repro_torch.launch.serve --arch internvl2-26b \\
        --param-dtype bfloat16 --policy kom_int14 --slots 4 --requests 8
    python -m repro_torch.launch.serve --arch recurrentgemma-9b \\
        --policy kom_int14 --slots 4 --requests 8
    python -m repro_torch.launch.serve --arch alexnet,vgg16 \\
        --policy kom_int14 --requests 8 --slo standard \\
        --fault-plan transient=0.2,poison=0.05

Runs on the GPU unless ``--device cpu`` is given (and refuses to start
without one otherwise).  ``--reduced`` serves the CPU-test twin of the
config (tiny widths); without it the model is served at full width (the
reference's LM launcher cannot turn its ``--reduced`` off; the port keeps
one rule for both halves).

``--arch a,b,...`` serves several models on one card through the
deadline-ordered :class:`~repro_torch.serving.dispatcher.
MultiModelDispatcher` (each name one of the registry's CNNs or LMs, each
model its own engine; a fleet tally closes the run).  ``--slo`` (a class:
``interactive``, ``standard``, ``batch``) or ``--deadline-ms`` gives every
request a latency budget on its engine's clock: an overdue request is
rejected with a typed ``Expired`` result, never served late, and printed
in the tally.  ``--retries N`` retries failed forwards (backoff, bisection
of a poisoned batch, typed ``Failed`` results); ``--fault-plan SPEC``
injects seeded faults (``transient=0.1,poison=0.02,oom=0.05,latency=0.1``,
see :meth:`~repro_torch.serving.faults.FaultPlan.parse`) and implies the
default retry policy unless ``--retries`` is given.  A bad spec, an
unknown arch or ``--retries 0`` is refused at argument-parse time.

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

LMs (the dense, MoE, xLSTM, hybrid and VLM families; the VLM is served
as its dense stack, without images, as in the reference; the hybrid's
local attention decodes through a ring of ``min(local_window, max_len)``
slots): ``--slots`` decode
slots, ``--max-len`` cache length, ``--max-new`` tokens per request,
``--param-dtype`` the params' dtype; each request's prompt is
``rng.integers(3, 9)`` random tokens, as in the reference.  An
encoder-decoder (``whisper-large-v3``) is refused with the reference's
message and exit code 2: the engine serves decoder-only families.
``--policy`` applies to every model named; without it each model gets
its own default: ``kom_int14`` for a CNN, the config's own
(``native_bf16``) for an LM.  An MoE decode step routes every slot row
as one group, so past its capacity (4 slots at olmoe-1b-7b's widths) a
request can lose an expert to its batch-mates, as in the reference.
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
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.scheduler import DEFAULT_SLO_BUDGETS, RetryPolicy


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


def _request_slo_kwargs(args, now) -> dict:
    """A request's deadline fields from the flags; ``now`` is its engine's
    clock (the warped one under a fault plan), the deadline's domain."""
    kw = {}
    if args.slo:
        kw["slo"] = args.slo
    if args.deadline_ms is not None:
        kw["deadline"] = now() + args.deadline_ms / 1e3
    return kw


def _resilience_kwargs(args) -> dict:
    """Engine retry/fault-injection kwargs from the validated flags."""
    kw = {}
    if args._retry is not None:
        kw["retry"] = args._retry
    if args._fault_plan is not None:
        kw["faults"] = args._fault_plan
    return kw


def _build_engine(cfg, args, device):
    """One engine on the card, CNN (warmed up) or LM, dispatcher-ready."""
    if cfg.family == "cnn":
        from repro_torch.models.cnn import cnn_init
        from repro_torch.serving.cnn_engine import CNNServeEngine

        gen = torch.Generator().manual_seed(args.seed)
        params = cnn_init(cfg, gen, device=device)
        buckets = tuple(int(b) for b in args.buckets.split(","))
        eng = CNNServeEngine(cfg, params, buckets=buckets, device=device,
                             plan=_cnn_plan(cfg, args, device),
                             tune=args.tune, **_resilience_kwargs(args))
        eng.warmup()
        return eng
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServeEngine

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = transformer.init_params(cfg, gen, device=device)
    return ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                       device=device, donate=True,
                       **_resilience_kwargs(args))


def _request(cfg, uid, rng, args, now):
    """Request ``uid`` for ``cfg``: a random image, or a prompt of
    ``rng.integers(3, 9)`` random tokens."""
    kw = _request_slo_kwargs(args, now)
    if cfg.family == "cnn":
        from repro_torch.serving.cnn_engine import ImageRequest

        h, c = cfg.img_size, cfg.in_channels
        img = rng.standard_normal((h, h, c)).astype(np.float32)
        return ImageRequest(uid=uid, image=img, **kw)
    from repro_torch.serving.engine import Request

    plen = int(rng.integers(3, 9))
    prompt = rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32)
    return Request(uid=uid, prompt=prompt, max_new_tokens=args.max_new, **kw)


def _where(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def _print_failures(engine, what: str) -> None:
    for uid, exp in sorted(engine.expired.items()):
        print(f"[serve] {what} {uid}: EXPIRED (deadline {exp.deadline:.3f} "
              f"< admission at {exp.expired_at:.3f})")
    for uid, flr in sorted(engine.failed.items()):
        print(f"[serve] {what} {uid}: FAILED after {flr.attempts} attempts "
              f"({flr.error})")


def serve_cnn(cfg, args) -> int:
    device = resolve_device(args.device)
    engine = _build_engine(cfg, args, device)
    rng = np.random.default_rng(args.seed)
    now = engine.request_queue.now
    t0 = time.time()
    for uid in range(args.requests):
        engine.submit(_request(cfg, uid, rng, args, now))
    done = engine.run()
    dt = time.time() - t0
    s = engine.stats()
    for uid in sorted(done):
        lat = engine.batcher.queue.latency(uid)
        print(f"[serve] img {uid}: label {done[uid].label} "
              f"({1e3 * lat:.1f} ms)")
    _print_failures(engine, "img")
    print(f"[serve] {cfg.name}/{cfg.policy.value}/{cfg.conv_path} on "
          f"{_where(device)}: {s['images_done']} images in {dt:.2f}s wall "
          f"({s['images_per_s']:.1f} img/s batched, "
          f"p50 latency {1e3 * s['latency_p50_s']:.1f} ms, "
          f"p95 latency {1e3 * s['latency_p95_s']:.1f} ms, "
          f"padding {100 * s['padding_fraction']:.0f}%, "
          f"expired {s['requests_expired']}, "
          f"failed {s['requests_failed']}, retries {s['retries']}, "
          f"health {s['health']}, buckets {s['bucket_counts']})", flush=True)
    served = len(done) + len(engine.expired) + len(engine.failed)
    return 0 if served == args.requests else 1


def serve_lm(cfg, args) -> int:
    if cfg.family == "encdec":
        print("engine serves decoder-only families; pick another arch")
        return 2
    device = resolve_device(args.device)
    engine = _build_engine(cfg, args, device)
    rng = np.random.default_rng(args.seed)
    now = engine.request_queue.now
    t0 = time.time()
    for uid in range(args.requests):
        engine.submit(_request(cfg, uid, rng, args, now))
    done = engine.run()
    dt = time.time() - t0
    n_tok = sum(len(r.out_tokens) for r in done.values())
    for uid in sorted(done):
        r = done[uid]
        print(f"[serve] req {uid}: prompt {[int(t) for t in r.prompt]} -> "
              f"{r.out_tokens}")
    _print_failures(engine, "req")
    print(f"[serve] {cfg.name}/{cfg.policy.value} on {_where(device)}: "
          f"{len(done)} requests ({len(engine.expired)} expired, "
          f"{len(engine.failed)} failed, {engine.retries} retries, health "
          f"{engine.health}), {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / dt:.1f} tok/s)", flush=True)
    served = len(done) + len(engine.expired) + len(engine.failed)
    return 0 if served == args.requests else 1


def serve_multi(cfgs, args) -> int:
    """Several models on one card, deadline-ordered time slices."""
    from repro_torch.serving.dispatcher import MultiModelDispatcher

    device = resolve_device(args.device)
    disp = MultiModelDispatcher()
    for cfg in cfgs:
        disp.register(cfg.name, _build_engine(cfg, args, device))
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    uid = 0
    for cfg in cfgs:
        now = disp.engine(cfg.name).request_queue.now
        for _ in range(args.requests):
            disp.submit(cfg.name, _request(cfg, uid, rng, args, now))
            uid += 1
    done = disp.run()
    dt = time.time() - t0
    s = disp.stats()
    for name in disp.models:
        q = disp.engine(name).request_queue
        print(f"[serve] {name}: {len(done[name])} done, "
              f"{len(q.expired)} expired, {len(q.failed)} failed, "
              f"health {s['health'][name]}, "
              f"{s['per_model'][name]['dispatch_steps']} dispatch steps")
    # the fleet rollup: the conservation triple and resilience counters
    print(f"[serve] fleet: {s['requests_done']} done, "
          f"{s['requests_expired']} expired, "
          f"{s['requests_failed']} failed, "
          f"{s['retries']} retries, {s['quarantined']} quarantined "
          f"across {len(cfgs)} models in {dt:.2f}s on {_where(device)}",
          flush=True)
    for name, err in s["contained"].items():
        print(f"[serve] contained: {name} downed by {err}")
    served = (s["requests_done"] + s["requests_expired"]
              + s["requests_failed"])
    return 0 if served == args.requests * len(cfgs) else 1


def _model_config(arch, args, ap):
    """``arch``'s config under the flags: its default policy unless
    ``--policy``; a CNN's conv path checked against the plan flags and
    the policy here, not mid-warmup."""
    if arch in ARCHS:
        cfg = get_config(arch)
        if args.policy:
            cfg = cfg.replace(policy=MatmulPolicy(args.policy))
        if args.param_dtype:
            cfg = cfg.replace(param_dtype=args.param_dtype)
        return reduced(cfg) if args.reduced else cfg
    cfg = get_config(arch, policy=MatmulPolicy(args.policy or "kom_int14"),
                     conv_path=args.conv_path)
    if cfg.conv_path != "auto" and (args.plan or args.explore):
        ap.error(f"--conv-path {cfg.conv_path} pins ONE engine for every "
                 "layer; --plan/--explore choose per layer -- drop one")
    try:
        validate_path_policy(cfg.conv_path, cfg.policy)
    except ValueError as e:
        ap.error(f"--conv-path {e}")
    return reduced(cfg) if args.reduced else cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="alexnet",
                    help="one arch, or a comma-separated list served on "
                         "one card by the multi-model dispatcher; each of "
                         + ", ".join(CNN_ARCHS + ARCHS))
    ap.add_argument("--policy", default=None,
                    choices=[p.value for p in MatmulPolicy],
                    help="default: kom_int14 for a CNN, the config's own "
                         "for an LM")
    ap.add_argument("--buckets", default="1,4,16",
                    help="microbatch bucket sizes (comma-separated)")
    ap.add_argument("--requests", type=int, default=32,
                    help="requests per model")
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
    ap.add_argument("--param-dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="LM: the params' dtype (default: the config's "
                         "own, float32; a full-width internvl2-26b needs "
                         "bfloat16 to fit one 80 GB card)")
    ap.add_argument("--slo", default=None,
                    choices=tuple(DEFAULT_SLO_BUDGETS),
                    help="SLO class of every request (its budget resolved "
                         "at submit; overdue requests are rejected, not "
                         "served late)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="explicit per-request latency budget in ms (wins "
                         "over --slo's class budget)")
    ap.add_argument("--retries", type=int, default=None, metavar="N",
                    help="retry failed forwards up to N attempts per "
                         "request (backoff, poison-batch bisection, typed "
                         "Failed results); default: no retry, a forward "
                         "failure propagates")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="deterministic fault injection, e.g. "
                         "'transient=0.1,poison=0.02,oom=0.05'; keys: "
                         "transient, poison, oom, latency, latency_s, "
                         "transient_fails, seed (validated here, not "
                         "mid-run); implies --retries 3 unless --retries "
                         "is given")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # The resilience flags fail here, not after model init and warmup.
    args._retry = None
    if args.retries is not None:
        try:
            args._retry = RetryPolicy(max_attempts=args.retries)
        except ValueError as e:
            ap.error(f"--retries: {e}")
    args._fault_plan = None
    if args.fault_plan is not None:
        try:
            args._fault_plan = FaultPlan.parse(args.fault_plan,
                                               seed=args.seed)
        except ValueError as e:
            ap.error(f"--fault-plan: {e}")
        if args._retry is None:
            args._retry = RetryPolicy()
    archs = [a.strip() for a in args.arch.split(",")]
    unknown = [a for a in archs if a not in CNN_ARCHS + ARCHS]
    if unknown:
        ap.error(f"--arch: unknown {unknown}; choose from "
                 f"{CNN_ARCHS + ARCHS}")
    if len(set(archs)) != len(archs):
        ap.error(f"--arch names a model twice: {args.arch}")
    if not any(a in CNN_ARCHS for a in archs):
        cnn_only = [f for f, on in (
            ("--explore", args.explore), ("--plan", args.plan),
            ("--model-only", args.model_only), ("--requant", args.requant),
            ("--tune", args.tune),
            ("--conv-path", args.conv_path != "auto")) if on]
        if cnn_only:
            ap.error(f"{', '.join(cnn_only)}: CNN flags; {args.arch} is "
                     "no CNN")
    if args.explore and args.plan:
        ap.error("--explore and --plan are mutually exclusive")
    if (args.model_only or args.requant) and not args.explore:
        ap.error("--model-only and --requant go with --explore")
    cfgs = [_model_config(a, args, ap) for a in archs]
    if len(cfgs) > 1:
        if any(c.family == "encdec" for c in cfgs):
            ap.error("the multi-model pool serves decoder-only LM families")
        return serve_multi(cfgs, args)
    if cfgs[0].family == "cnn":
        return serve_cnn(cfgs[0], args)
    return serve_lm(cfgs[0], args)


if __name__ == "__main__":
    sys.exit(main())
