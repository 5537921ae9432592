"""Whole-network ExecutionPlan: the port of ``repro.core.planner``'s plan
artifact, heuristic and resolution chain.

* :class:`ExecutionPlan` / :class:`LayerPlan` keep the reference's
  ``execution-plan/v1`` JSON schema, so a plan written by either package
  drives the other.
* :func:`heuristic_path` is the port's single call site of
  :func:`~repro_torch.core.substrate.select_conv_path`.
* :func:`resolve_plan`: an explicit plan, else the heuristic plan.  The
  backend ``"cuda"`` has no committed artifact; the design-space explorer
  and the tile tuner that would write one are not ported yet, and the
  port's kernels choose their own tiles.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

from .substrate import policy_int_spec, select_conv_path

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
    """Backend-stamp mismatch between a plan and the running device."""


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
    ``fma(raw, t, b)`` epilogue, so degraded logits equal healthy ones.
    Pool fusions are downgraded to ``bias_relu``.
    """
    entries = tuple(dataclasses.replace(
        e, path="im2col", block=None, est_us=None, roofline_frac=None,
        fusion="bias_relu" if e.fusion in ("pool", "pool_quant")
        else e.fusion,
        source="fallback")
        for e in plan.entries)
    return dataclasses.replace(plan, entries=entries)


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
