"""Batched LM serving engine on the port: prefill + continuous batched decode.

The port of ``repro.serving.engine``:

* a fixed decode batch of ``slots``; requests join the port's copy of the
  reference scheduler (:mod:`repro_torch.serving.scheduler`) and are
  admitted into free slots earliest-deadline-first (overdue requests are
  rejected with typed ``Expired`` results);
* a prompt is prefilled token by token through ``serve_step`` into its
  slot, then the slot decodes one token per engine step beside every other
  active slot -- each position group steps with a write mask, so
  batch-mates at other positions cannot clobber a slot's cache rows;
* a reused slot's cache rows are reset to the pristine cache at admission;
* per-slot positions live on the host, the cache on the device;
* integer policies quantize the matmul weights ONCE at build
  (:func:`~repro_torch.serving.weight_quant.quantize_params_inline`);
  ``donate=True`` lets the engine quantize the caller's param tree in
  place (its float leaves are then gone), so that a model whose float and
  quantized weights do not fit on the card side by side still builds;
* retries with backoff and bisection, and the OOM degrade ladder (halve
  the admission slot cap, then go down with requests failed typed);
* fault injection: ``faults=`` (a :class:`~repro_torch.serving.faults.
  FaultPlan` or :class:`~repro_torch.serving.faults.FaultInjector`) is
  checked before every decode call and its latency draw taken after it;
  the queue then runs on the injector's warped clock.  The cache is only
  committed on success, so a retried request's greedy tokens equal a
  fault-free run's;
* the dispatcher protocol (``request_queue``, ``has_work()``,
  ``urgency()``, ``step()``).

Runs on the GPU unless ``device="cpu"``.  The decode step is
``transformer.serve_step``, eagerly (no ``jit``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.substrate import policy_int_spec
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving.clock import with_faults
from repro_torch.serving.scheduler import (EngineDownError, IncompleteRunError,
                                           RequestQueue, RetryPolicy,
                                           classify_failure, wait_until)
from repro_torch.serving.weight_quant import quantize_params_inline


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (prompt_len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: Optional[List[int]] = None
    deadline: Optional[float] = None   # absolute, engine clock domain
    slo: Optional[str] = None          # named class -> budget at submit


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 512, rng_seed: int = 0,
                 prequantize: bool | None = None,
                 slo_budgets: Optional[dict] = None, clock=None,
                 retry: Optional[RetryPolicy] = None,
                 faults=None, advance=None, device=None,
                 donate: bool = False):
        if cfg.family in ("encdec",):
            raise NotImplementedError("engine serves decoder-only families")
        self.cfg = cfg
        self.device = resolve_device(device)
        spec = policy_int_spec(cfg.policy)
        if prequantize is None:
            prequantize = spec is not None
        quantize = prequantize and spec is not None
        if quantize and donate:
            # the caller's tree, in place, before anything else holds its
            # leaves: each float weight is freed as its QWeight is made
            quantize_params_inline(params, base_bits=spec[1], in_place=True)
        params = transformer.params_to(params, self.device)
        if quantize and not donate:
            params = quantize_params_inline(params, base_bits=spec[1])
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.cache = transformer.init_cache(cfg, slots, max_len,
                                            device=self.device)
        # pristine per-slot state for admission-time reset
        self._cache0 = transformer.init_cache(cfg, slots, max_len,
                                              device=self.device)
        self.pos = np.zeros((slots,), np.int64)      # next position per slot
        self.active: List[Optional[Request]] = [None] * slots
        self.health = "healthy"
        self.degrade_log: List[str] = []
        self._slot_cap = slots
        self.retry = retry
        self._advance = advance
        self.retries = 0
        self.bisections = 0
        self.quarantined = 0
        self.fault_counts: Dict[str, int] = {"transient": 0, "oom": 0}
        # under faults the queue runs on the injector's warped clock
        self.faults, run_clock = with_faults(faults, clock)
        kw = {} if run_clock is None else {"clock": run_clock}
        self._rq = RequestQueue(slo_budgets=slo_budgets, **kw)
        self._rng = np.random.default_rng(rng_seed)

    # -- device steps ---------------------------------------------------------

    def _mask(self, rows) -> torch.Tensor:
        m = np.zeros((self.slots,), bool)
        m[list(rows)] = True
        return torch.from_numpy(m).to(self.device)

    def _decode(self, tok: np.ndarray, pos: int, mask: torch.Tensor):
        t = torch.from_numpy(tok).to(self.device)
        return transformer.serve_step(self.params, self.cfg, self.cache, t,
                                      pos, write_mask=mask)

    @torch.inference_mode()
    def _reset_rows(self, mask: torch.Tensor) -> None:
        """Every cache leaf's rows in ``mask`` back to the pristine cache: a
        reused slot must not leak the previous occupant's state (position
        masking hides stale KV rows, but mLSTM/sLSTM state has no position,
        and the sLSTM normalizer starts at ones, not zeros)."""
        def reset(a, a0):
            return torch.where(mask.reshape((1, -1) + (1,) * (a.ndim - 2)),
                               a0, a)
        self.cache = transformer.map_tree(reset, self.cache, self._cache0)

    # -- admission -----------------------------------------------------------

    @property
    def queue(self) -> List[Request]:
        return list(self._rq.pending)

    @property
    def done(self) -> Dict[int, Request]:
        return self._rq.done

    @property
    def expired(self) -> Dict[int, object]:
        return self._rq.expired

    @property
    def failed(self) -> Dict[int, object]:
        return self._rq.failed

    @property
    def request_queue(self) -> RequestQueue:
        return self._rq

    def has_work(self) -> bool:
        return bool(len(self._rq)) or any(r is not None for r in self.active)

    def urgency(self) -> tuple:
        return self._rq.urgency()

    def submit(self, req: Request):
        if self.health == "down":
            raise EngineDownError(
                "engine is down; submit to a healthy engine")
        req.out_tokens = []
        self._rq.submit(req, deadline=req.deadline, slo=req.slo)

    def _admit(self):
        # reject overdue requests, then fill free slots EDF; degraded mode
        # admits into the first `_slot_cap` slots only
        self._rq.expire_overdue()
        for s in range(min(self.slots, self._slot_cap)):
            if self.active[s] is None:
                admitted = self._rq.take(1, order="edf")
                if not admitted:
                    break
                self._prefill_slot(s, admitted[0])

    # -- health ---------------------------------------------------------------

    def _degrade(self) -> bool:
        """Shed capacity after an OOM-shaped failure; False = nothing left."""
        if self._slot_cap > 1:
            self._slot_cap = max(1, self._slot_cap // 2)
            self.health = "degraded"
            self.degrade_log.append(f"slot cap halved to {self._slot_cap}")
            return True
        self.mark_down("degraded-mode options exhausted after OOM")
        return False

    def mark_down(self, reason: str = "engine marked down") -> list:
        """Go ``down``: active and pending requests are failed typed."""
        self.health = "down"
        err = EngineDownError(reason)
        out = []
        for s, req in enumerate(self.active):
            if req is not None:
                out.append(self._rq.fail(req, error=err))
                self.active[s] = None
        out.extend(self._rq.fail_pending(err))
        return out

    def _record_fault(self, exc: BaseException, uids) -> str:
        """Classify + bookkeep one failed decode; fatal errors re-raise."""
        kind = classify_failure(exc)
        if kind == "fatal":
            raise exc
        now = self._rq.now()
        self.fault_counts[kind] = self.fault_counts.get(kind, 0) + 1
        for uid in uids:
            self._rq.record_attempt(uid, now, exc)
        return kind

    def _backoff(self, fails: int, uids) -> None:
        """Back off on the engine clock, capped by the earliest deadline."""
        self.retries += 1
        now = self._rq.now()
        target = now + self.retry.backoff(fails)
        deadlines = [self._rq.timing[u].deadline for u in uids
                     if self._rq.timing[u].deadline is not None]
        if deadlines:
            target = min(target, min(deadlines))
        wait_until(self._rq.now, target, self._advance)

    def _expire_slots(self, slot_ids: List[int]) -> List[int]:
        """Expire active slots whose deadline passed during backoff."""
        now = self._rq.now()
        keep = []
        for s in slot_ids:
            req = self.active[s]
            d = self._rq.timing[req.uid].deadline
            if d is not None and d <= now:
                self._rq.expire(req, now)
                self.active[s] = None
            else:
                keep.append(s)
        return keep

    def _prefill_slot(self, slot: int, req: Request):
        """Run the prompt through the decode path token by token, writing
        only this slot's cache rows (the write mask)."""
        self.active[slot] = req
        self.pos[slot] = 0
        mask = self._mask([slot])
        self._reset_rows(mask)
        for t in req.prompt:
            tok = np.zeros((self.slots, 1), np.int32)
            tok[slot, 0] = t
            fails = 0
            while True:
                # retry-safe: the cache is only committed on success
                try:
                    if self.faults is not None:
                        self.faults.check((req.uid,))
                    _, cache = self._decode(tok, int(self.pos[slot]), mask)
                    if self.faults is not None:
                        self.faults.lag()
                except Exception as exc:
                    kind = self._record_fault(exc, (req.uid,))
                    fails += 1
                    if kind == "oom" and not self._degrade():
                        return    # mark_down already failed this request
                    if self.health == "down":
                        return
                    if self.retry is None:
                        self._rq.fail(req, error=exc)
                        self.active[slot] = None
                        raise
                    if (self._rq.timing[req.uid].attempts
                            >= self.retry.max_attempts):
                        self._rq.fail(req, error=exc)
                        self.quarantined += 1
                        self.active[slot] = None
                        return
                    self._backoff(fails, (req.uid,))
                    if not self._expire_slots([slot]):
                        return
                    continue
                self.cache = cache
                self.pos[slot] += 1
                break

    # -- decode --------------------------------------------------------------

    def _sample(self, logits_row: np.ndarray, temperature: float) -> int:
        v = self.cfg.vocab_size
        logits_row = logits_row[:v]
        if temperature <= 0.0:
            return int(np.argmax(logits_row))
        p = np.exp((logits_row - logits_row.max()) / temperature)
        p /= p.sum()
        return int(self._rng.choice(v, p=p))

    def step(self):
        """One engine step: decode one token for every active slot."""
        if self.health == "down":
            raise EngineDownError("engine is down")
        self._admit()
        if not any(r is not None for r in self.active):
            return False
        tok = np.zeros((self.slots, 1), np.int32)
        for s, req in enumerate(self.active):
            if req is not None:
                tok[s, 0] = (req.out_tokens or [int(req.prompt[-1])])[-1]
        # slots decode at their own positions: step each position group,
        # the write mask restricting cache changes to the group's slots
        groups: Dict[int, List[int]] = {}
        for s, req in enumerate(self.active):
            if req is not None:
                groups.setdefault(int(self.pos[s]), []).append(s)
        for pos, slot_ids in groups.items():
            self._step_group(pos, slot_ids, tok)
            if self.health == "down":
                break
        return True

    def _step_group(self, pos: int, slot_ids: List[int], tok: np.ndarray,
                    suspect: bool = False) -> None:
        """Decode one token for the slots at ``pos``; retry/bisect faults."""
        fails = 0
        slot_ids = list(slot_ids)
        while True:
            if not slot_ids:
                return
            uids = tuple(self.active[s].uid for s in slot_ids)
            t = np.zeros((self.slots, 1), np.int32)
            for s in slot_ids:
                t[s, 0] = tok[s, 0]
            try:
                if self.faults is not None:
                    self.faults.check(uids)
                logits, cache = self._decode(t, pos, self._mask(slot_ids))
                logits = logits.reshape(self.slots, -1).float().cpu().numpy()
                if self.faults is not None:
                    self.faults.lag()
            except Exception as exc:
                kind = self._record_fault(exc, uids)
                fails += 1
                if kind == "oom" and not self._degrade():
                    return        # mark_down already failed these requests
                if self.health == "down":
                    return
                if self.retry is None:
                    raise
                if len(slot_ids) == 1:
                    s = slot_ids[0]
                    req = self.active[s]
                    if (self._rq.timing[req.uid].attempts
                            >= self.retry.max_attempts):
                        self._rq.fail(req, error=exc)
                        self.quarantined += 1
                        self.active[s] = None
                        return
                elif fails >= (1 if suspect else self.retry.bisect_after):
                    self.bisections += 1
                    mid = len(slot_ids) // 2
                    self._step_group(pos, slot_ids[:mid], tok, suspect=True)
                    if self.health != "down":
                        self._step_group(pos, slot_ids[mid:], tok,
                                         suspect=True)
                    return
                self._backoff(fails, uids)
                slot_ids = self._expire_slots(slot_ids)
                continue
            self.cache = cache
            for s in slot_ids:
                req = self.active[s]
                req.out_tokens.append(self._sample(logits[s],
                                                   req.temperature))
                self.pos[s] += 1
                if (len(req.out_tokens) >= req.max_new_tokens
                        or self.pos[s] >= self.max_len - 1):
                    self._rq.finish(req)
                    self.active[s] = None
            return

    def run(self, max_steps: int = 10_000):
        """Serve until queue and slots drain; raise if max_steps cuts it."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        if self.has_work():
            stranded = [r.uid for r in self._rq.pending] + \
                [r.uid for r in self.active if r is not None]
            raise IncompleteRunError(self._rq.done, stranded, max_steps)
        return self._rq.done

    # -- accounting -----------------------------------------------------------

    def stats(self) -> dict:
        """Request/resilience roll-up (the CNN engine's stats analogue)."""
        s = {
            "requests_done": len(self._rq.done),
            "requests_expired": len(self._rq.expired),
            "requests_failed": len(self._rq.failed),
            "retries": self.retries,
            "bisections": self.bisections,
            "quarantined": self.quarantined,
            "fault_counts": dict(self.fault_counts),
            "health": self.health,
            "degrade_log": list(self.degrade_log),
            "slots": self.slots,
            "slot_cap": self._slot_cap,
            "device": str(self.device),
        }
        if self.faults is not None:
            s["faults"] = self.faults.stats()
        return s
