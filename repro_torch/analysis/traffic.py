"""Whole-network device-memory traffic: per-layer bytes under a fusion plan.

The port of ``repro.analysis.traffic``.  :func:`~repro_torch.core.tuning.
conv_hbm_bytes` models ONE conv call on the port's kernels; this module
walks a whole CNN (:func:`~repro_torch.models.cnn.cnn_layer_topology`)
under an :class:`~repro_torch.core.planner.ExecutionPlan` and prices what
each conv position's effective fusion moves:

* an unfused maxpool is its own pass (read the full f32 conv output,
  write the pooled quarter);
* ``fusion="pool"`` folds it into the implicit kernel's epilogue, so only
  the pooled f32 map is written;
* ``fusion="pool_quant"`` also emits the next layer's handoff (padded int16
  values and the cell-scale grid, ``conv_hbm_bytes`` prices that pass), and
  the consumer reads int16 (``handoff_in``).

The effective fusion at each position follows ``cnn_forward``'s rule, the
reference's rule: plan entries are keyed by geometry, so a pool fusion
fires only where a maxpool follows and the engine is implicit, pool_quant
only where an eligible 3x3/s1 consumer follows under an integer policy,
and a handoff consumer always runs on the implicit engine.  ``fused=False``
prices the unfused pipeline of the same plan (conv, ``pool2d``, then
``handoff_quantize`` as separate passes).  The byte counts are the port's
model; the fusion sequence is the reference's.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.planner import (_policy_variant, geometry_key,
                                      resolve_plan)
from repro_torch.core.substrate import policy_int_spec
from repro_torch.core.tuning import conv_hbm_bytes
from repro_torch.models.cnn import cnn_layer_topology

_GKEYS = ("kh", "kw", "stride", "h", "cin", "cout", "padding")


def _out_size(t: dict) -> int:
    if t["padding"] == "VALID":
        return (t["h"] - t["kh"]) // t["stride"] + 1
    return -(-t["h"] // t["stride"])


def _pool_pass_bytes(t: dict, n: int) -> int:
    """The standalone 2x2/s2 maxpool after conv ``t``: read, write."""
    ho = _out_size(t)
    hp = max(ho // 2, 1)
    return (n * ho * ho + n * hp * hp) * t["cout"] * 4


def _handoff_pass_bytes(t: dict, n: int) -> int:
    """The standalone ``handoff_quantize`` after the pool: read the pooled
    f32, write the padded int16 values and the cell grid."""
    hp = max(_out_size(t) // 2, 1)
    c = t["cout"]
    return (n * hp * hp * c * 4 + n * (hp + 2) * (hp + 2) * c * 2
            + n * -(-hp // 2) * -(-hp // 2) * 4)


def model_traffic(cfg, plan=None, *, n: int = 1, fused: bool = True,
                  backend: str = "cuda") -> Dict:
    """Per-position and total modeled bytes of one forward of ``cfg``.

    ``plan`` resolves through the chain (explicit > committed >
    heuristic) on ``backend`` (an explicit plan's own backend).
    ``fused=False`` prices the unfused pipeline of the same plan.  Returns
    ``{"model", "policy", "fused", "n", "layers", "total_bytes",
    "pooled_total_bytes"}``; ``pooled_total_bytes`` sums the pool-followed
    positions (conv + pool + handoff passes).
    """
    if plan is not None:
        backend = plan.backend
    plan = resolve_plan(cfg, plan, backend=backend)
    variant, _ = _policy_variant(cfg.policy)
    int_policy = policy_int_spec(cfg.policy) is not None
    rows: List[dict] = []
    handoff_next_in = False
    total = pooled_total = 0
    for t in cnn_layer_topology(cfg):
        key = geometry_key(**{k: t[k] for k in _GKEYS})
        ent = plan.by_key.get(key)
        path = ent.path if ent is not None else "im2col"
        fusion = ent.fusion if ent is not None else "bias_relu"
        handoff_in = handoff_next_in
        if handoff_in:
            path = "implicit"
        do_pool = (fused and fusion in ("pool", "pool_quant")
                   and path == "implicit" and t["pool_after"])
        do_quant = (do_pool and fusion == "pool_quant" and int_policy
                    and t["handoff_next"])
        eff = "pool_quant" if do_quant else ("pool" if do_pool else (
            fusion if fusion in ("none", "bias_relu") else "bias_relu"))
        shape = {k: t[k] for k in ("kh", "kw", "stride", "h", "cin", "cout")}
        conv_bytes = conv_hbm_bytes(path, variant=variant, n=n, fusion=eff,
                                    handoff_in=handoff_in, **shape)
        pool_bytes = _pool_pass_bytes(t, n) \
            if t["pool_after"] and not do_pool else 0
        unfused_quant = (not do_quant and fusion == "pool_quant"
                         and int_policy and t["handoff_next"])
        quant_bytes = _handoff_pass_bytes(t, n) if unfused_quant else 0
        layer_total = conv_bytes + pool_bytes + quant_bytes
        rows.append(dict(key=key, path=path, fusion=eff,
                         handoff_in=handoff_in, pool_after=t["pool_after"],
                         conv_bytes=conv_bytes, pool_bytes=pool_bytes,
                         quant_bytes=quant_bytes, total_bytes=layer_total))
        total += layer_total
        if t["pool_after"]:
            pooled_total += layer_total
        handoff_next_in = do_quant or unfused_quant
    return {"model": cfg.name,
            "policy": getattr(cfg.policy, "value", cfg.policy),
            "fused": fused, "n": n, "layers": rows,
            "total_bytes": total, "pooled_total_bytes": pooled_total}


def fusion_traffic_report(cfg, plan=None, *, n: int = 1,
                          backend: str = "cuda") -> Dict:
    """Fused against unfused modeled bytes for one (model, plan)."""
    f = model_traffic(cfg, plan, n=n, fused=True, backend=backend)
    u = model_traffic(cfg, plan, n=n, fused=False, backend=backend)

    def _red(a, b):
        return round(1.0 - a / b, 4) if b else 0.0
    return {"model": f["model"], "policy": f["policy"], "n": n,
            "fused_bytes": f["total_bytes"],
            "unfused_bytes": u["total_bytes"],
            "reduction": _red(f["total_bytes"], u["total_bytes"]),
            "pooled_fused_bytes": f["pooled_total_bytes"],
            "pooled_unfused_bytes": u["pooled_total_bytes"],
            "pooled_reduction": _red(f["pooled_total_bytes"],
                                     u["pooled_total_bytes"])}
