"""Whole-network ExecutionPlan: the port of ``repro.core.planner``.

* :class:`ExecutionPlan` / :class:`LayerPlan` keep the reference's
  ``execution-plan/v1`` JSON schema, so a plan written by either package
  drives the other.
* :func:`explore`: per conv layer, the candidate engines
  (:func:`candidate_paths`) scored either by measured wall time of the
  public :func:`~repro_torch.core.substrate.conv2d`, fused and unfused, on
  the device (:func:`_measure_paths`; the winner's Cin chunk refined by
  :func:`~repro_torch.core.tuning.tune_layer`), or -- ``model_only=True``
  -- by the H100 roofline floor (:mod:`repro_torch.analysis.roofline` over
  the port's traffic model).  Then the topology-driven fusion axis:
  ``pool`` on every pool-followed implicit layer, ``pool_quant`` under
  ``requant`` when the layer has a handoff consumer.  A layer no
  candidate scored falls back to the heuristic with ``source="default"``
  and a log line.
* :func:`heuristic_path` is the port's single call site of
  :func:`~repro_torch.core.substrate.select_conv_path`; its thin-stem
  threshold comes from the tuner (:func:`~repro_torch.core.tuning.stem_cin`).
* :func:`resolve_plan`: an explicit plan, else the committed artifact
  ``repro_torch/tuned/plans/<backend>.json`` (:func:`committed_plan`),
  else the heuristic plan.  ``python -m repro_torch.core.planner --check``
  validates the artifacts (:func:`check`), ``--explore`` writes them.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import pathlib
import re
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

from .substrate import (FUSIONS, INT_POLICY_SPECS, path_supports_fusion,
                        path_supports_policy, policy_int_spec,
                        select_conv_path)

PLAN_SCHEMA = "execution-plan/v1"
PLANS_DIRNAME = "plans"

#: Provenance tags of a LayerPlan entry: its score came from a
#: measurement, the cost model, or the heuristic fallback.
SOURCES = ("measured", "model", "default")

#: Engines whose entry records the block its kernel runs.
TUNABLE_KINDS = ("implicit", "systolic", "winograd")

#: What a conv wrapper raises when it refuses a shape or a policy, before
#: any launch: the explorer prunes such a candidate.  Anything else (a
#: failed build, a CUDA error) propagates.
_REFUSALS = (ValueError, TypeError)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One conv layer's execution: engine, tiles, epilogue fusion."""

    key: str
    path: str
    block: Optional[tuple]
    fusion: str = "bias_relu"
    est_us: Optional[float] = None
    hbm_bytes: Optional[int] = None
    roofline_us: Optional[float] = None
    roofline_frac: Optional[float] = None
    exactness_bound: Optional[float] = None
    source: str = "default"

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["block"] = list(self.block) if self.block is not None else None
        return d

    @classmethod
    def from_json(cls, d: dict) -> "LayerPlan":
        d = dict(d)
        if d.get("block") is not None:
            d["block"] = tuple(int(b) for b in d["block"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Per-layer execution choices for one (model, policy, backend)."""

    model: str
    policy: str
    backend: str
    entries: Tuple[LayerPlan, ...]
    schema: str = PLAN_SCHEMA

    @functools.cached_property
    def by_key(self) -> Dict[str, LayerPlan]:
        return {e.key: e for e in self.entries}

    def lookup(self, *, kh, kw, stride, h, cin, cout,
               padding) -> Optional[LayerPlan]:
        return self.by_key.get(geometry_key(kh=kh, kw=kw, stride=stride,
                                            h=h, cin=cin, cout=cout,
                                            padding=padding))

    def to_json(self) -> dict:
        return {"model": self.model, "policy": self.policy,
                "layers": [e.to_json() for e in self.entries]}

    @classmethod
    def from_json(cls, d: dict, *, backend: str) -> "ExecutionPlan":
        return cls(model=d["model"], policy=d["policy"], backend=backend,
                   entries=tuple(LayerPlan.from_json(e)
                                 for e in d["layers"]))


class PlanArtifactError(ValueError):
    """Schema-version or backend-stamp mismatch in a plan or an artifact."""


def plan_key(model: str, policy) -> str:
    """Artifact key of one (model, policy) plan."""
    return f"{model}|{getattr(policy, 'value', policy)}"


def geometry_key(*, kh, kw, stride, h, cin, cout, padding) -> str:
    """Stable per-layer key: the exact shape tuple conv2d is called with."""
    return f"k{kh}x{kw}|s{stride}|h{h}|cin{cin}|cout{cout}|{padding}"


def parse_geometry_key(key: str) -> dict:
    """Invert :func:`geometry_key`."""
    m = re.fullmatch(
        r"k(\d+)x(\d+)\|s(\d+)\|h(\d+)\|cin(\d+)\|cout(\d+)\|(SAME|VALID)",
        key)
    if m is None:
        raise ValueError(f"malformed geometry key: {key!r}")
    kh, kw, stride, h, cin, cout = (int(v) for v in m.groups()[:6])
    return dict(kh=kh, kw=kw, stride=stride, h=h, cin=cin, cout=cout,
                padding=m.group(7))


def heuristic_path(*, kh: int, kw: int, stride: int, cin: int, cout: int,
                   policy=None, cached_weight: bool = False,
                   padding: str = "SAME", backend: str = "cuda",
                   stem_cin: Optional[int] = None) -> str:
    """The shape/policy dispatch rule, its thin-stem threshold from the
    tuner's cache for ``backend`` (:func:`~repro_torch.core.tuning.stem_cin`)
    unless ``stem_cin`` is given."""
    if stem_cin is None:
        from .tuning import stem_cin as tuned_stem_cin
        stem_cin = tuned_stem_cin(backend)
    return select_conv_path(
        kh=kh, kw=kw, stride=stride, cin=cin, cout=cout, policy=policy,
        cached_weight=cached_weight, padding=padding, stem_cin=stem_cin)


def heuristic_plan(cfg, *, backend: str = "cuda") -> ExecutionPlan:
    """The fallback plan: every conv layer on ``heuristic_path``'s engine,
    ``block=None``, ``fusion="bias_relu"``."""
    from repro_torch.models.cnn import cnn_conv_geometries

    cached = policy_int_spec(cfg.policy) is not None
    entries, seen = [], set()
    for g in cnn_conv_geometries(cfg):
        key = geometry_key(**g)
        if key in seen:
            continue
        seen.add(key)
        path = heuristic_path(policy=cfg.policy, cached_weight=cached,
                              backend=backend,
                              **{k: v for k, v in g.items() if k != "h"})
        entries.append(LayerPlan(key=key, path=path, block=None,
                                 source="default"))
    return ExecutionPlan(model=cfg.name,
                         policy=getattr(cfg.policy, "value", cfg.policy),
                         backend=backend, entries=tuple(entries))


def materialized_fallback_plan(plan: ExecutionPlan) -> ExecutionPlan:
    """Reroute every conv layer to the materialized im2col path.

    The degraded-mode plan after OOM-shaped failures.  The im2col path
    honors every policy and, under the integer policies, gives the same
    integers as the implicit and Winograd engines (one shared plan of
    per-patch or per-tile activation scales, one exact recombine) and the
    same ``fma(raw, t, b)`` epilogue.  Pool fusions are downgraded to
    ``bias_relu`` (the pool runs as its own ``pool2d``).  What the
    degraded logits equal:

    * the healthy plan's logits, bit for bit, only when ``plan`` holds no
      ``systolic`` layer and no ``pool`` or ``pool_quant`` fusion;
    * otherwise this plan's own forward, and not the healthy logits: the
      systolic engine quantizes per sample, a ``pool_quant`` consumer reads
      the handoff's power-of-two cell quantization (the carve-out the
      reference documents), and a pooled layer rounds ``max(fl(raw*t)) +
      b`` where the materialized one rounds ``max(fma(raw, t, b))``;
    * every plan of the committed ``repro_torch/tuned/plans/cuda.json``
      holds systolic layers, so it is in the second case.

    The reference's docstring claims the first case for every plan but a
    ``pool_quant`` one; its systolic engine quantizes per sample too, so
    the claim does not hold there for a systolic layer either.
    """
    entries = tuple(dataclasses.replace(
        e, path="im2col", block=None, est_us=None, roofline_frac=None,
        fusion="bias_relu" if e.fusion in ("pool", "pool_quant")
        else e.fusion,
        source="fallback")
        for e in plan.entries)
    return dataclasses.replace(plan, entries=entries)


# ---------------------------------------------------------------------------
# The design-space explorer.
# ---------------------------------------------------------------------------

def _policy_variant(policy) -> tuple:
    pv = getattr(policy, "value", policy)
    if pv in INT_POLICY_SPECS:
        return INT_POLICY_SPECS[pv]
    if pv in ("bf16x3", "bf16x6", "native_bf16"):
        return (pv, 7)
    return ("native", 7)


def candidate_paths(*, kh, kw, stride, cin, cout, padding, policy,
                    backend: str) -> List[str]:
    """Engines of the port that run this layer exactly on ``backend``.

    im2col honors every policy.  On ``"cuda"`` (the reference's TPU
    branch: the engines run compiled) the implicit engine runs every
    policy it implements and the systolic engine its shape niche
    (``max(kh, kw) <= 7``, ``stride <= 2``, ``cin >= stem``, ``cout %
    128 == 0``); elsewhere (the reference's CPU list) implicit runs the
    integer policies only and systolic is no candidate.  Winograd needs an
    integer policy, 3x3/s1/SAME and the growth bound.  Streaming engines
    need ``cin >= stem``, the tuner's thin-stem threshold.
    """
    from repro_torch.kernels.conv2d.winograd import winograd_accum_bound

    from .tuning import stem_cin

    stem = stem_cin(backend)
    spec = policy_int_spec(policy)
    compiled = backend == "cuda"
    paths = ["im2col"]
    if path_supports_policy("implicit", policy) and cin >= stem \
            and (spec is not None or compiled):
        paths.append("implicit")
    if compiled and path_supports_policy("systolic", policy) \
            and max(kh, kw) <= 7 and stride <= 2 and cin >= stem \
            and cout % 128 == 0:
        paths.append("systolic")
    if spec is not None and (kh, kw, stride, padding) == (3, 3, 1, "SAME") \
            and cin >= stem and winograd_accum_bound(
                cin, variant=spec[0], base_bits=spec[1]) < 2**31:
        paths.append("winograd")
    return paths


def _tkey(t: dict) -> str:
    """The geometry key of a topology (or geometry) row."""
    return geometry_key(**{k: t[k] for k in ("kh", "kw", "stride", "h",
                                             "cin", "cout", "padding")})


def _topology_keys(cfg) -> tuple:
    """(keys followed by a maxpool, keys that feed a handoff consumer)."""
    from repro_torch.models.cnn import cnn_layer_topology

    topo = cnn_layer_topology(cfg)
    return ({_tkey(t) for t in topo if t["pool_after"]},
            {_tkey(t) for t in topo if t["handoff_next"]})


def _entry_bound(path: str, *, kh, kw, cin, variant, base_bits
                 ) -> Optional[float]:
    """The int32 accumulation bound the chosen engine must stay under."""
    if variant not in ("karatsuba", "schoolbook"):
        return None
    from repro_torch.kernels.conv2d.conv2d import int_accum_bound
    from repro_torch.kernels.conv2d.winograd import winograd_accum_bound

    if path == "winograd":
        return float(winograd_accum_bound(cin, variant=variant,
                                          base_bits=base_bits))
    return float(int_accum_bound(kh, kw, cin, variant=variant,
                                 base_bits=base_bits))


def _measure_paths(paths, *, kh, kw, stride, h, cin, cout, padding, policy,
                   iters: int, verbose: bool, device=None) -> dict:
    """Wall-time each candidate through the public ``conv2d`` on ``device``.

    Seed-0 batch-1 operands made with numpy (the weight a cached QWeight
    under an integer policy, so per-weight state such as the Winograd
    planes engages as in the engine); each engine timed fused
    (``bias=, activation="relu"``) and unfused (bias and ReLU after it) by
    :func:`~repro_torch.core.tuning._time_call`.  Returns ``{path: (us,
    fused_us, unfused_us)}``; a candidate the wrapper refuses
    (ValueError/TypeError, before any launch) is left out, any other
    error propagates.
    """
    import numpy as np
    import torch

    from repro_torch.device import resolve_device

    from .substrate import conv2d, quantize_weight
    from .tuning import _time_call

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, h, h, cin)).astype(
        np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((kh, kw, cin, cout)) * 0.1
                          ).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((cout,)).astype(
        np.float32)).to(dev)
    spec = policy_int_spec(policy)
    if spec is not None:
        w = quantize_weight(w, base_bits=spec[1])
    out = {}
    with torch.inference_mode():
        for path in paths:
            fused = functools.partial(
                conv2d, stride=stride, padding=padding, policy=policy,
                path=path, bias=b, activation="relu")

            def unfused(a, q, p=path):
                return torch.relu(conv2d(a, q, stride=stride,
                                         padding=padding, policy=policy,
                                         path=p) + b)
            try:
                us_f = _time_call(fused, x, w, iters=iters)
                us_u = _time_call(unfused, x, w, iters=iters)
            except _REFUSALS as e:
                if verbose:
                    print(f"    {path}: refused ({type(e).__name__}: {e})")
                continue
            if verbose:
                print(f"    {path}: fused {us_f:.1f} us, unfused "
                      f"{us_u:.1f} us")
            out[path] = (min(us_f, us_u), us_f, us_u)
    return out


def explore(cfg, *, model_only: bool = False, backend: str = "cuda",
            iters: int = 3, tune_tiles: bool = True, requant: bool = False,
            verbose: bool = False, device=None) -> ExecutionPlan:
    """Search path x fusion (x the implicit Cin chunk) per conv layer.

    Measured (the default): every candidate of :func:`candidate_paths` on
    ``backend`` is wall-timed through the public ``conv2d`` on ``device``
    (default: the GPU) at batch 1 (:func:`_measure_paths`), the fastest
    wins, its fusion is ``bias_relu`` unless the unfused call was faster
    (``none``), and with ``tune_tiles`` the implicit engine's Cin chunk is
    swept (:func:`~repro_torch.core.tuning.tune_layer`).  ``source`` is
    ``measured``, and ``roofline_frac`` the H100 floor over the wall.

    ``model_only=True`` ranks by
    :func:`~repro_torch.analysis.roofline.conv_layer_roofline` (H100
    peaks, the port's traffic model; no execution, deterministic), over
    the candidates every backend runs (``candidate_paths(backend="cpu")``):
    the engines only the card runs -- systolic, the float implicit
    variants -- issue the same multiplies as the implicit engine, so the
    floor cannot tell them apart; measurement ranks them.

    Then the topology's fusion axis (:func:`~repro_torch.models.cnn.
    cnn_layer_topology`): an implicit layer followed by the 2x2/s2 maxpool
    gets ``"pool"``; with ``requant=True`` and an integer policy, one that
    also feeds an eligible 3x3/s1 consumer gets ``"pool_quant"`` (a
    quantization-recipe change, hence opt-in).  A layer none of whose
    candidates scored falls back to the heuristic path with
    ``source="default"``, logged.
    """
    from repro_torch.analysis.roofline import conv_layer_roofline
    from repro_torch.models.cnn import cnn_conv_geometries, cnn_layer_topology

    from .tuning import conv_hbm_bytes, resolve_block, tune_layer

    variant, base_bits = _policy_variant(cfg.policy)
    is_int = policy_int_spec(cfg.policy) is not None
    topo = cnn_layer_topology(cfg)
    pool_keys, producer_keys = _topology_keys(cfg)
    handoff_pairs = [(_tkey(topo[i]), _tkey(topo[i + 1]))
                     for i in range(len(topo) - 1)
                     if topo[i]["handoff_next"]]
    fallback = heuristic_plan(cfg, backend=backend)
    entries: List[LayerPlan] = []
    planned: Dict[str, str] = {}
    for g in cnn_conv_geometries(cfg):
        key = geometry_key(**g)
        if key in planned:
            continue
        shape = {k: g[k] for k in ("kh", "kw", "stride", "h", "cin", "cout")}
        paths = candidate_paths(
            padding=g["padding"], policy=cfg.policy,
            backend="cpu" if model_only else backend,
            **{k: g[k] for k in ("kh", "kw", "stride", "cin", "cout")})
        if verbose:
            print(f"  {key}: candidates {paths}")
        roof = {p: conv_layer_roofline(p, variant=variant, **shape)
                for p in paths}
        best, est_us, fusion, source = None, None, "bias_relu", "default"
        if model_only:
            scored = {p: 1e6 * roof[p]["roofline_s"] for p in paths}
            best = min(scored, key=scored.get)
            est_us, source = scored[best], "model"
        else:
            walls = _measure_paths(paths, padding=g["padding"],
                                   policy=cfg.policy, iters=iters,
                                   verbose=verbose, device=device, **shape)
            if walls:
                best = min(walls, key=lambda p: walls[p][0])
                est_us, us_f, us_u = walls[best]
                fusion = "bias_relu" if us_f <= us_u else "none"
                source = "measured"
        if best is None:
            best = fallback.by_key[key].path
            print(f"[planner] {cfg.name}/{key}: no candidate scored, "
                  f"falling back to heuristic path {best!r} "
                  "(source=default)")
        if best == "implicit" and key in pool_keys:
            fusion = "pool"
            if requant and is_int and key in producer_keys:
                fusion = "pool_quant"
        planned[key] = fusion
        handoff_in = any(planned.get(p) == "pool_quant"
                         for p, c in handoff_pairs if c == key)
        block = None
        if best in TUNABLE_KINDS:
            if not model_only and tune_tiles:
                block = tuple(tune_layer(best, variant=variant,
                                         base_bits=base_bits, iters=iters,
                                         device=device, **shape))
            else:
                block = tuple(resolve_block(best, variant=variant,
                                            base_bits=base_bits,
                                            backend=backend, **shape))
        r = roof.get(best)
        roof_us = 1e6 * r["roofline_s"] if r else None
        # A handoff consumer runs on the implicit engine whatever it
        # planned (cnn_forward's rule), so its bytes are the implicit's.
        entries.append(LayerPlan(
            key=key, path=best, block=block, fusion=fusion,
            est_us=round(est_us, 3) if est_us is not None else None,
            hbm_bytes=conv_hbm_bytes("implicit" if handoff_in else best,
                                     variant=variant, fusion=fusion,
                                     handoff_in=handoff_in, **shape),
            roofline_us=round(roof_us, 3) if roof_us is not None else None,
            roofline_frac=(round(roof_us / est_us, 6)
                           if source == "measured" and est_us else None),
            exactness_bound=_entry_bound(best, kh=g["kh"], kw=g["kw"],
                                         cin=g["cin"], variant=variant,
                                         base_bits=base_bits),
            source=source))
    return ExecutionPlan(model=cfg.name,
                         policy=getattr(cfg.policy, "value", cfg.policy),
                         backend=backend, entries=tuple(entries))


# ---------------------------------------------------------------------------
# Plan artifacts: repro_torch/tuned/plans/<backend>.json
# ---------------------------------------------------------------------------

def plans_dir() -> pathlib.Path:
    """Where the port keeps plan artifacts: ``plans/`` under the tuner's
    directory (never the reference's ``benchmarks/tuned/plans/``)."""
    from .tuning import tuned_dir
    return tuned_dir() / PLANS_DIRNAME


def plan_path(backend: str = "cuda") -> pathlib.Path:
    return plans_dir() / f"{backend}.json"


def save_plans(plans: Iterable[ExecutionPlan],
               path: Optional[os.PathLike] = None) -> pathlib.Path:
    """Write (merge) plans of ONE backend into its artifact file."""
    plans = list(plans)
    if not plans:
        raise ValueError("no plans to save")
    backend = plans[0].backend
    if any(p.backend != backend for p in plans):
        raise ValueError("one artifact file holds ONE backend's plans")
    path = pathlib.Path(path) if path is not None else plan_path(backend)
    payload = {"schema": PLAN_SCHEMA, "backend": backend, "plans": {}}
    if path.exists():
        try:
            old = json.loads(path.read_text())
            if old.get("schema") == PLAN_SCHEMA \
                    and old.get("backend") == backend:
                payload["plans"] = old.get("plans", {})
        except (ValueError, OSError):
            pass
    for p in plans:
        payload["plans"][plan_key(p.model, p.policy)] = p.to_json()
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_plans(path, *, backend: str = "cuda") -> Dict[str, ExecutionPlan]:
    """All plans in one artifact file, checked against ``backend``.

    Raises :class:`PlanArtifactError` on a schema-version mismatch or a
    foreign backend stamp: a plan made for another device never silently
    drives this one.
    """
    p = pathlib.Path(path)
    data = json.loads(p.read_text())
    if data.get("schema") != PLAN_SCHEMA:
        raise PlanArtifactError(
            f"{p}: schema {data.get('schema')!r} != {PLAN_SCHEMA!r}")
    if data.get("backend") != backend:
        raise PlanArtifactError(
            f"{p}: plan artifact is stamped backend={data.get('backend')!r}"
            f", this process runs {backend!r}")
    return {k: ExecutionPlan.from_json(v, backend=backend)
            for k, v in data.get("plans", {}).items()}


def committed_plan(model: str, policy,
                   backend: str = "cuda") -> Optional[ExecutionPlan]:
    """The committed artifact's plan for (model, policy) on ``backend``, or
    None when the artifact has none.  A foreign stamp or a stale schema
    raises (:class:`PlanArtifactError`)."""
    path = plan_path(backend)
    if not path.exists():
        return None
    return load_plans(path, backend=backend).get(plan_key(model, policy))


def resolve_plan(cfg, plan: Optional[ExecutionPlan] = None, *,
                 backend: str = "cuda") -> ExecutionPlan:
    """Explicit plan (checked against cfg and backend) > the committed
    artifact for (model, policy, backend) > the heuristic plan.

    Committed plans describe the full-size models; a reduced twin's
    geometries miss every entry, and each such layer falls back to auto
    dispatch in the forward.
    """
    if plan is not None:
        pv = getattr(cfg.policy, "value", cfg.policy)
        if (plan.model, plan.policy) != (cfg.name, pv):
            raise ValueError(
                f"plan is for {plan.model}|{plan.policy}, config is "
                f"{cfg.name}|{pv}")
        if plan.backend != backend:
            raise PlanArtifactError(
                f"plan is stamped backend={plan.backend!r}, this process "
                f"runs {backend!r}")
        return plan
    hit = committed_plan(cfg.name, cfg.policy, backend=backend)
    if hit is not None:
        return hit
    return heuristic_plan(cfg, backend=backend)


# ---------------------------------------------------------------------------
# Check mode: validate the committed artifacts, no execution.
# ---------------------------------------------------------------------------

def _check_entry(ent: LayerPlan, g: dict, *, policy: str, is_int: bool,
                 pool_keys, producer_keys, where: str) -> List[str]:
    from .tuning import feasible

    errors = []
    variant, base_bits = _policy_variant(policy)
    if ent.source not in SOURCES:
        errors.append(f"{where}: bad source {ent.source!r}")
    if ent.path not in ("im2col", *TUNABLE_KINDS):
        return errors + [f"{where}: unknown path {ent.path!r}"]
    if not path_supports_policy(ent.path, policy):
        return errors + [f"{where}: path {ent.path!r} cannot run policy "
                         f"{policy!r} exactly"]
    if ent.fusion not in FUSIONS:
        return errors + [f"{where}: unknown fusion {ent.fusion!r} (expected "
                         f"one of {list(FUSIONS)})"]
    if not path_supports_fusion(ent.path, ent.fusion):
        errors.append(f"{where}: fusion {ent.fusion!r} is not implementable "
                      f"by path {ent.path!r} (pooled epilogue is "
                      "implicit-engine only)")
    if ent.fusion in ("pool", "pool_quant") and ent.key not in pool_keys:
        errors.append(f"{where}: fusion {ent.fusion!r} but no maxpool "
                      "follows this geometry")
    if ent.fusion == "pool_quant":
        if not is_int:
            errors.append(f"{where}: pool_quant needs an integer policy, "
                          f"plan is {policy!r}")
        elif ent.key not in producer_keys:
            errors.append(f"{where}: pool_quant but no eligible 3x3/s1 "
                          "handoff consumer follows")
    bound = _entry_bound(ent.path, kh=g["kh"], kw=g["kw"], cin=g["cin"],
                         variant=variant, base_bits=base_bits)
    if bound is not None and bound >= 2**31:
        errors.append(f"{where}: {ent.path} accumulation bound "
                      f"{bound:.3g} wraps int32")
    if ent.path in TUNABLE_KINDS and ent.block is not None:
        fus = ent.fusion if ent.fusion in FUSIONS and path_supports_fusion(
            ent.path, ent.fusion) else "bias_relu"
        ok, why = feasible(ent.path, kh=g["kh"], kw=g["kw"],
                           stride=g["stride"], h=g["h"], cin=g["cin"],
                           cout=g["cout"], variant=variant,
                           base_bits=base_bits, block=tuple(ent.block),
                           fusion=fus)
        if not ok:
            errors.append(f"{where}: block {list(ent.block)} -- {why}")
    return errors


def check(paths: Optional[Iterable[os.PathLike]] = None) -> List[str]:
    """Validate plan artifacts (default: every file in :func:`plans_dir`);
    returns the violations.

    Per file: current schema, backend stamp equal to the file name.  Per
    plan: a registered CNN, an entry for every conv geometry of the
    full-size model and none for another, a known ``source``, an engine
    that runs the policy exactly, a fusion the engine implements and the
    topology allows (pool only where a maxpool follows, pool_quant only
    under an integer policy with a 3x3/s1 consumer), a block the tuner
    finds feasible, and an int32 bound below 2^31.
    """
    from repro_torch.configs import get_config
    from repro_torch.models.cnn import cnn_conv_geometries

    if paths is None:
        d = plans_dir()
        paths = sorted(d.glob("*.json")) if d.exists() else []
    errors: List[str] = []
    for path in paths:
        path = pathlib.Path(path)
        try:
            plans = load_plans(path, backend=path.stem)
        except (PlanArtifactError, ValueError, OSError) as e:
            errors.append(f"{path.name}: {e}")
            continue
        for pkey, plan in plans.items():
            where = f"{path.name}:{pkey}"
            try:
                cfg = get_config(plan.model)
            except KeyError:
                errors.append(f"{where}: unknown model {plan.model!r}")
                continue
            if getattr(cfg, "family", None) != "cnn":
                errors.append(f"{where}: {plan.model!r} is not a CNN -- "
                              "plans cover conv spines only")
                continue
            cfg = cfg.replace(policy=_as_policy(plan.policy, errors, where))
            pool_keys, producer_keys = _topology_keys(cfg)
            want: Dict[str, dict] = {}
            for g in cnn_conv_geometries(cfg):
                want.setdefault(geometry_key(**g), g)
            for key, g in want.items():
                ent = plan.by_key.get(key)
                if ent is None:
                    errors.append(f"{where}: layer {key} has NO entry "
                                  "(silent coverage gap)")
                    continue
                errors += _check_entry(
                    ent, g, policy=plan.policy,
                    is_int=plan.policy in INT_POLICY_SPECS,
                    pool_keys=pool_keys, producer_keys=producer_keys,
                    where=f"{where}/{key}")
            for key in sorted(set(plan.by_key) - set(want)):
                errors.append(f"{where}: entry {key} matches no conv layer "
                              f"of {plan.model}")
    return errors


def _as_policy(pv: str, errors: list, where: str):
    from .precision import MatmulPolicy
    try:
        return MatmulPolicy(pv)
    except ValueError:
        errors.append(f"{where}: unknown policy {pv!r}")
        return MatmulPolicy.FP32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Validate the committed plan artifacts (--check) or "
                    "explore plans on a device and write them (--explore).")
    ap.add_argument("--check", action="store_true",
                    help="validate repro_torch/tuned/plans/*.json")
    ap.add_argument("--explore", action="store_true",
                    help="run the explorer and write the plans")
    ap.add_argument("--model-only", action="store_true",
                    help="rank by the H100 roofline cost model, no "
                         "execution")
    ap.add_argument("--models", nargs="*",
                    default=["alexnet", "vgg16", "vgg19"])
    ap.add_argument("--policies", nargs="*",
                    default=["kom_int14", "schoolbook_int16"])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--requant", action="store_true",
                    help="allow the pool_quant handoff fusion")
    ap.add_argument("--device", default=None,
                    help="device of the measured explorer (default: the "
                         "GPU); its type is the plans' backend")
    ap.add_argument("--out", default=None,
                    help="artifact path (default repro_torch/tuned/plans/"
                         "<backend>.json)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.check:
        errors = check()
        for e in errors:
            print(f"PLAN VIOLATION: {e}")
        d = plans_dir()
        n_files = len(list(d.glob("*.json"))) if d.exists() else 0
        print(f"plan artifacts: {n_files} file(s), {len(errors)} "
              "violation(s)")
        return 1 if errors else 0
    if args.explore:
        from repro_torch.configs import get_config
        from repro_torch.device import resolve_device

        from .precision import MatmulPolicy

        backend = "cuda" if args.model_only and args.device is None \
            else resolve_device(args.device).type
        plans = []
        for name in args.models:
            for pv in args.policies:
                cfg = get_config(name).replace(policy=MatmulPolicy(pv))
                print(f"[planner] exploring {name}|{pv} "
                      f"({'cost model' if args.model_only else 'measured'}"
                      f", {backend})")
                plan = explore(cfg, model_only=args.model_only,
                               backend=backend, iters=args.iters,
                               requant=args.requant, verbose=args.verbose,
                               device=args.device)
                for e in plan.entries:
                    blk = list(e.block) if e.block else "-"
                    print(f"  {e.key}: {e.path} block={blk} "
                          f"fusion={e.fusion} est_us={e.est_us} "
                          f"source={e.source}")
                plans.append(plan)
        out = save_plans(plans, path=args.out)
        print(f"[planner] wrote {out}")
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
