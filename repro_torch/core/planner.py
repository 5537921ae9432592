"""Whole-network ExecutionPlan: the port of ``repro.core.planner``'s plan
artifact, explorer, heuristic and resolution chain.

* :class:`ExecutionPlan` / :class:`LayerPlan` keep the reference's
  ``execution-plan/v1`` JSON schema, so a plan written by either package
  drives the other.
* :func:`explore` (``model_only=True``): per conv layer, the candidate
  engines (:func:`candidate_paths`) ranked by the H100 roofline floor
  (:mod:`repro_torch.analysis.roofline` over the port's traffic model),
  then the topology-driven fusion axis: ``pool`` on every pool-followed
  implicit layer, ``pool_quant`` under ``requant`` when the layer has a
  handoff consumer.  Measured exploration and the tile tuner are not
  ported yet.
* :func:`heuristic_path` is the port's single call site of
  :func:`~repro_torch.core.substrate.select_conv_path`.
* :func:`resolve_plan`: an explicit plan, else the heuristic plan.  The
  backend ``"cuda"`` has no committed artifact, so the default path of a
  model does not change; :func:`save_plans`/:func:`load_plans` keep port
  artifacts under ``repro_torch/tuned/plans/``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

from .substrate import (INT_POLICY_SPECS, STEM_CIN, not_ported,
                        path_supports_policy, policy_int_spec,
                        select_conv_path)

PLAN_SCHEMA = "execution-plan/v1"


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


def heuristic_path(*, kh: int, kw: int, stride: int, cin: int, cout: int,
                   policy=None, cached_weight: bool = False,
                   padding: str = "SAME") -> str:
    """The shape/policy dispatch rule; thin-stem threshold
    :data:`~repro_torch.core.substrate.STEM_CIN`."""
    return select_conv_path(
        kh=kh, kw=kw, stride=stride, cin=cin, cout=cout, policy=policy,
        cached_weight=cached_weight, padding=padding)


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
                              **{k: v for k, v in g.items() if k != "h"})
        entries.append(LayerPlan(key=key, path=path, block=None,
                                 source="default"))
    return ExecutionPlan(model=cfg.name,
                         policy=getattr(cfg.policy, "value", cfg.policy),
                         backend=backend, entries=tuple(entries))


def materialized_fallback_plan(plan: ExecutionPlan) -> ExecutionPlan:
    """Reroute every conv layer to the materialized im2col path.

    The degraded-mode plan after OOM-shaped failures: the im2col path honors
    every policy and, under the integer policies, gives the same integers
    (per-patch or shared per-tile scales, one exact recombine) and the same
    ``fma(raw, t, b)`` epilogue as the unfused engines, so for a plan
    without pool fusions the degraded logits equal the healthy ones.  Pool
    fusions are downgraded to ``bias_relu`` (the pool runs as its own
    ``pool2d``).  Under a plan with them the degraded logits equal the
    reference's degraded (materialized) forward, NOT necessarily the
    healthy logits: a ``pool_quant`` plan's consumers read the handoff's
    power-of-two cell quantization (the carve-out the reference
    documents), and a pooled layer rounds ``max(fl(raw*t)) + b`` where the
    materialized one rounds ``max(fma(raw, t, b))``.
    """
    entries = tuple(dataclasses.replace(
        e, path="im2col", block=None, est_us=None, roofline_frac=None,
        fusion="bias_relu" if e.fusion in ("pool", "pool_quant")
        else e.fusion,
        source="fallback")
        for e in plan.entries)
    return dataclasses.replace(plan, entries=entries)


# ---------------------------------------------------------------------------
# The design-space explorer (model-only).
# ---------------------------------------------------------------------------

def _policy_variant(policy) -> tuple:
    pv = getattr(policy, "value", policy)
    if pv in INT_POLICY_SPECS:
        return INT_POLICY_SPECS[pv]
    if pv in ("bf16x3", "bf16x6", "native_bf16"):
        return (pv, 7)
    return ("native", 7)


def candidate_paths(*, kh, kw, stride, cin, padding, policy) -> List[str]:
    """Engines of the port that run this layer exactly, pruned.

    im2col honors every policy.  implicit runs the integer policies above
    the thin-stem threshold; winograd needs an integer policy,
    3x3/s1/SAME, ``cin >= STEM_CIN`` and the growth bound.  The reference
    lists the systolic engine and the implicit float variants only on the
    TPU; the port runs both when a caller pins ``conv_path``, and leaves
    ranking them on the card to the measured explorer (ROADMAP.md).  The
    candidates are the same on every device.
    """
    from repro_torch.kernels.conv2d.winograd import winograd_accum_bound

    paths = ["im2col"]
    spec = policy_int_spec(policy)
    if spec is not None and cin >= STEM_CIN \
            and path_supports_policy("implicit", policy):
        paths.append("implicit")
    if spec is not None and (kh, kw, stride, padding) == (3, 3, 1, "SAME") \
            and cin >= STEM_CIN and winograd_accum_bound(
                cin, variant=spec[0], base_bits=spec[1]) < 2**31:
        paths.append("winograd")
    return paths


def _entry_block(path: str, *, kh, kw, cin, variant, base_bits):
    """The tiles ``path``'s kernel runs with.  For implicit, ``bk`` is the
    Cin chunk the kernel reads: it sets the recombine groups and the
    handoff consumer's f32 order."""
    from repro_torch.kernels.conv2d.implicit_gemm import max_cin_block
    from .tuning import IMPLICIT_TILE, WINOGRAD_TILE

    if path == "implicit":
        bk = cin
        if variant in ("karatsuba", "schoolbook"):
            bk = min(cin, max_cin_block(kh, kw, variant=variant,
                                        base_bits=base_bits))
        return (*IMPLICIT_TILE, bk)
    if path == "winograd":
        return WINOGRAD_TILE
    return None


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


def explore(cfg, *, model_only: bool = False, backend: str = "cuda",
            requant: bool = False) -> ExecutionPlan:
    """Search path x fusion per conv layer of ``cfg`` with the cost model.

    ``model_only=True`` ranks each layer's candidates by
    :func:`~repro_torch.analysis.roofline.conv_layer_roofline` (H100
    peaks, the port's traffic model; no execution, deterministic).  The
    fusion axis comes from the topology
    (:func:`~repro_torch.models.cnn.cnn_layer_topology`): an implicit
    layer followed by the 2x2/s2 maxpool gets ``"pool"``; with
    ``requant=True`` and an integer policy, one that also feeds an
    eligible 3x3/s1 consumer gets ``"pool_quant"`` (a quantization-recipe
    change, hence opt-in).  Measured exploration (``model_only=False``)
    and the tile tuner are not ported yet.
    """
    if not model_only:
        raise not_ported("measured exploration (explore(model_only=False))",
                         "Queue 1 item 6: the measured explorer and the "
                         "tile tuner")
    from repro_torch.analysis.roofline import conv_layer_roofline
    from repro_torch.models.cnn import cnn_conv_geometries, cnn_layer_topology

    from .tuning import conv_hbm_bytes

    variant, base_bits = _policy_variant(cfg.policy)
    is_int = policy_int_spec(cfg.policy) is not None
    topo = cnn_layer_topology(cfg)
    shape_keys = ("kh", "kw", "stride", "h", "cin", "cout", "padding")
    tkey = lambda t: geometry_key(**{k: t[k] for k in shape_keys})
    pool_keys = {tkey(t) for t in topo if t["pool_after"]}
    handoff_pairs = [(tkey(topo[i]), tkey(topo[i + 1]))
                     for i in range(len(topo) - 1)
                     if topo[i]["handoff_next"]]
    producer_keys = {p for p, _ in handoff_pairs}
    entries: List[LayerPlan] = []
    planned: Dict[str, str] = {}
    for g in cnn_conv_geometries(cfg):
        key = geometry_key(**g)
        if key in planned:
            continue
        shape = {k: g[k] for k in ("kh", "kw", "stride", "h", "cin", "cout")}
        paths = candidate_paths(padding=g["padding"], policy=cfg.policy,
                                **{k: g[k] for k in ("kh", "kw", "stride",
                                                     "cin")})
        scored = {p: 1e6 * conv_layer_roofline(p, variant=variant,
                                               **shape)["roofline_s"]
                  for p in paths}
        best = min(scored, key=scored.get)
        fusion = "bias_relu"
        if best == "implicit" and key in pool_keys:
            fusion = "pool"
            if requant and is_int and key in producer_keys:
                fusion = "pool_quant"
        planned[key] = fusion
        handoff_in = any(planned.get(p) == "pool_quant"
                         for p, c in handoff_pairs if c == key)
        entries.append(LayerPlan(
            key=key, path=best,
            block=_entry_block(best, kh=g["kh"], kw=g["kw"], cin=g["cin"],
                               variant=variant, base_bits=base_bits),
            fusion=fusion, est_us=round(scored[best], 3),
            hbm_bytes=conv_hbm_bytes(best, variant=variant, fusion=fusion,
                                     handoff_in=handoff_in, **shape),
            roofline_us=round(scored[best], 3), roofline_frac=None,
            exactness_bound=_entry_bound(best, kh=g["kh"], kw=g["kw"],
                                         cin=g["cin"], variant=variant,
                                         base_bits=base_bits),
            source="model"))
    return ExecutionPlan(model=cfg.name,
                         policy=getattr(cfg.policy, "value", cfg.policy),
                         backend=backend, entries=tuple(entries))


# ---------------------------------------------------------------------------
# Plan artifacts: repro_torch/tuned/plans/<backend>.json
# ---------------------------------------------------------------------------

def plans_dir() -> pathlib.Path:
    """Where the port keeps plan artifacts (never the reference's
    ``benchmarks/tuned/plans/``)."""
    return pathlib.Path(__file__).resolve().parent.parent / "tuned" / "plans"


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


def resolve_plan(cfg, plan: Optional[ExecutionPlan] = None, *,
                 backend: str = "cuda") -> ExecutionPlan:
    """Explicit plan (checked against cfg and backend) > heuristic plan."""
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
    return heuristic_plan(cfg, backend=backend)
