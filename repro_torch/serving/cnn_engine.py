"""Batched CNN serving engine on the port: AlexNet/VGG16/VGG19 on the card.

The port of ``repro.serving.cnn_engine``:

* **Continuous, SLO-aware admission** through the port's copy of the
  reference scheduler (:mod:`repro_torch.serving.scheduler`): EDF
  admission into a few batch buckets, zero-padded microbatches, typed
  ``Expired``/``Failed`` results, retries.
* **Quantize-once weights**: under the integer policies the float params
  become cached :class:`~repro_torch.core.substrate.QWeight` leaves once at
  build; each step quantizes activations only, per row / patch / tile /
  sample, so a request's logits do not depend on its batch-mates or
  padding.  The float policies (``fp32``, ``bf16x3``, ``bf16x6``) serve the
  float params as they are.
* **Planned conv dispatch**: the ExecutionPlan is resolved once at build,
  unless ``cfg.conv_path`` pins one engine for every layer (``systolic``,
  ``implicit``, ...), which excludes a plan; a fused plan (``pool``/``pool_quant`` entries, e.g. from
  ``explore(cfg, model_only=True, requant=True)``) runs the implicit
  kernel's pooled epilogue and its int16 handoff between layers.
* **OOM degrade ladder**: drop the largest bucket, then reroute the plan to
  :func:`~repro_torch.core.planner.materialized_fallback_plan`, then go
  down with pending requests failed typed.  The degraded logits equal the
  healthy ones for plans without pool fusions; the reroute downgrades pool
  fusions, so under a ``pool``/``pool_quant`` plan they equal the
  reference's degraded (materialized) forward instead.

PyTorch runs eagerly, so there is no compile step: each bucket shape is
simply a forward.  Data parallelism over a mesh and fault injection are
not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.substrate import not_ported, validate_path_policy
from repro_torch.device import resolve_device
from repro_torch.models.cnn import CNNConfig, cnn_forward, cnn_quantize_params
from repro_torch.serving.scheduler import (EngineDownError,
                                           IncompleteRunError, Microbatcher,
                                           RetryPolicy)


@dataclasses.dataclass
class ImageRequest:
    uid: int
    image: np.ndarray                     # (H, W, C) float32
    logits: Optional[np.ndarray] = None   # (n_classes,) set at completion
    label: Optional[int] = None           # argmax(logits)
    deadline: Optional[float] = None      # absolute, engine clock domain
    slo: Optional[str] = None             # named class -> budget at submit


def params_to(params, device) -> list:
    """Every tensor / QWeight of a param list moved to ``device``."""
    return [{k: v.to(device) for k, v in p.items()} for p in params]


class CNNServeEngine:
    """Serve batched image-classification requests for a :class:`CNNConfig`.

    ``device``: where the model runs, ``cuda`` unless the caller passes
    ``"cpu"`` (see :func:`~repro_torch.device.resolve_device`).
    """

    def __init__(self, cfg: CNNConfig, params, *,
                 buckets: Sequence[int] = (1, 4, 16, 64), device=None,
                 plan=None, retry: Optional[RetryPolicy] = None, mesh=None,
                 faults=None):
        if mesh is not None:
            raise not_ported("CNNServeEngine(mesh=...)",
                             "Queue 1 item 10: distribution")
        if faults is not None:
            raise not_ported("CNNServeEngine(faults=...)",
                             "Queue 1 item 7: fault injection")
        self.cfg = cfg
        self.device = resolve_device(device)
        # Integer policies: weights become cached QWeights ONCE, here.
        self.params = cnn_quantize_params(params_to(params, self.device), cfg)
        self.plan = None
        if cfg.conv_path == "auto":
            from repro_torch.core.planner import resolve_plan
            self.plan = resolve_plan(cfg, plan, backend=self.device.type)
        elif plan is not None:
            raise ValueError(
                f"explicit conv_path={cfg.conv_path!r} and an ExecutionPlan "
                "are mutually exclusive -- drop one")
        else:
            validate_path_policy(cfg.conv_path, cfg.policy)
        self.health = "healthy"
        self.degrade_log: List[str] = []
        self._fallback_plan_active = False
        self.batcher = Microbatcher(buckets, retry=retry,
                                    on_fault=self._on_fault)

    @property
    def buckets(self) -> tuple:
        return self.batcher.buckets

    # -- admission -----------------------------------------------------------

    def submit(self, req: ImageRequest) -> None:
        if self.health == "down":
            raise EngineDownError(
                f"{self.cfg.name} engine is down; submit to a healthy engine")
        img = np.asarray(req.image, np.float32)
        h = self.cfg.img_size
        if img.shape != (h, h, self.cfg.in_channels):
            raise ValueError(
                f"{self.cfg.name} serves ({h}, {h}, {self.cfg.in_channels}) "
                f"images, got {img.shape}")
        self.batcher.submit(req, img, deadline=req.deadline, slo=req.slo)

    @property
    def expired(self):
        return self.batcher.queue.expired

    @property
    def failed(self):
        return self.batcher.queue.failed

    # -- health ---------------------------------------------------------------

    def _degrade(self) -> bool:
        """Shed capacity after an OOM-shaped failure; False = nothing left."""
        dropped = self.batcher.drop_largest_bucket()
        if dropped is not None:
            self.health = "degraded"
            self.degrade_log.append(f"dropped bucket {dropped}")
            return True
        if self.plan is not None and not self._fallback_plan_active:
            from repro_torch.core.planner import materialized_fallback_plan
            self.plan = materialized_fallback_plan(self.plan)
            self._fallback_plan_active = True
            self.health = "degraded"
            self.degrade_log.append("rerouted plan to materialized im2col")
            return True
        self.mark_down("degraded-mode options exhausted after OOM")
        return False

    def _on_fault(self, kind: str, exc: BaseException, uids) -> bool:
        if self.health == "down":
            return True
        if kind != "oom":
            return False
        return not self._degrade()

    def mark_down(self, reason: str = "engine marked down") -> list:
        self.health = "down"
        return self.batcher.queue.fail_pending(EngineDownError(reason))

    # -- execution -----------------------------------------------------------

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits for a batch already on the engine's device."""
        with torch.inference_mode():
            return cnn_forward(self.params, self.cfg, x, plan=self.plan)

    def run_batch(self, batch: np.ndarray) -> np.ndarray:
        """One zero-padded microbatch (host) -> its logits (host)."""
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
        return self.forward(x).cpu().numpy()

    def warmup(self) -> None:
        """Run every bucket shape once (kernel builds and allocator warm-up),
        then once more, timed, to seed the batcher's per-bucket cost model."""
        h, c = self.cfg.img_size, self.cfg.in_channels
        for b in self.batcher.buckets:
            zeros = np.zeros((b, h, h, c), np.float32)
            self.run_batch(zeros)
            t0 = time.perf_counter()
            self.run_batch(zeros)
            self.batcher.record_service(b, time.perf_counter() - t0)

    def step(self) -> List[ImageRequest]:
        """Serve one microbatch; returns the requests completed by it."""
        if self.health == "down":
            raise EngineDownError(f"{self.cfg.name} engine is down")
        completed = self.batcher.step(self.run_batch)
        out = []
        for req, logits in completed:
            req.logits = logits
            req.label = int(np.argmax(logits))
            out.append(req)
        return out

    def run(self, max_steps: int = 10_000) -> Dict[int, ImageRequest]:
        """Drain the queue; raises IncompleteRunError if max_steps cuts it."""
        steps = 0
        while len(self.batcher.queue) and steps < max_steps:
            self.step()
            steps += 1
        if len(self.batcher.queue):
            raise IncompleteRunError(
                self.batcher.queue.done,
                [r.uid for r in self.batcher.queue.pending], max_steps)
        return self.batcher.queue.done

    # -- accounting -----------------------------------------------------------

    def stats(self) -> dict:
        s = self.batcher.stats()
        s["images_done"] = s.pop("requests_done")
        s["images_per_s"] = s.pop("throughput_rps")
        s["buckets"] = self.batcher.buckets
        s["health"] = self.health
        s["degrade_log"] = list(self.degrade_log)
        s["device"] = str(self.device)
        return s
