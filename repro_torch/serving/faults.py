"""Deterministic fault injection for the serving runtime.

The port's copy of the JAX package's ``repro/serving/faults.py``, which
imports only numpy, ``zlib`` and the standard library: the port keeps its
own copy so that it never imports the JAX package.  The two copies hold the
same definitions; ``tests/test_torch_serving.py`` checks that they stay
identical below this docstring.

A :class:`FaultPlan` declares a seeded fault mix; a :class:`FaultInjector`
realizes it by wrapping an engine's ``run_batch`` (and optionally the
injected clock).  The injected failure kinds mirror the organic ones the
scheduler's :func:`~repro_torch.serving.scheduler.classify_failure` knows:

* **transient** -- a forward fails once (or a few times) then heals;
  exercises retry/backoff.
* **poison** -- a forward fails EVERY time a chosen request uid is in the
  batch; exercises bisection + quarantine (innocent batch-mates must
  still serve).
* **oom** -- the failure message carries an OOM marker
  (``RESOURCE_EXHAUSTED``), so engines additionally take their degraded-
  mode transitions, as they do on a real ``torch.OutOfMemoryError``
  ("CUDA out of memory").
* **latency** -- no failure; the wrapped clock jumps forward by
  ``latency_s`` after the forward, modeling a slow step (pushes requests
  toward their deadlines).

Determinism contract: whether a given REQUEST is poisoned or transiently
faulted is a pure function of ``(seed, kind, uid)`` -- decided by a
``numpy`` Generator seeded through ``SeedSequence`` with ``zlib.crc32`` of
the kind (never Python's per-process ``hash``) -- so the fault outcome for
request 17 is the same no matter how requests were batched, retried, or
reordered, and the same in both packages.  That is what makes chaos runs
replayable byte-for-byte, and what lets tests assert that retried
requests' logits are bitwise identical to a fault-free run.  Only
``latency_rate`` and ``oom_rate`` draw per-CALL (a latency spike belongs to
a step, not a request); they are deterministic for a fixed call sequence
and documented as schedule-coupled.

No ``time.*`` calls anywhere here: the injector only reads/wraps the
clock it is given (grep-contract in tests/test_torch_serving.py).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np


class TransientFault(RuntimeError):
    """Injected failure that heals after a bounded number of attempts."""


class PoisonFault(RuntimeError):
    """Injected failure tied to a request uid; never heals."""


class OOMFault(RuntimeError):
    """Injected OOM-shaped failure (message carries an OOM marker)."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative, seeded fault mix.

    Rates are per-unit probabilities in [0, 1].  ``transient_rate`` /
    ``poison_rate`` are per-REQUEST (hash of ``(seed, kind, uid)``);
    ``oom_rate`` / ``latency_rate`` are per-CALL.  ``transient_fails`` is
    how many times a transiently-faulted request's batch fails before
    healing.  ``poison_uids`` force-poisons specific uids on top of the
    rate draw (tests use this for exact scenarios).
    """

    seed: int = 0
    transient_rate: float = 0.0
    transient_fails: int = 1
    poison_rate: float = 0.0
    poison_uids: Tuple[int, ...] = ()
    oom_rate: float = 0.0
    latency_rate: float = 0.0
    latency_s: float = 0.020

    def __post_init__(self):
        for name in ("transient_rate", "poison_rate", "oom_rate",
                     "latency_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1]: {v}")
        if self.transient_fails < 1:
            raise ValueError(
                f"transient_fails must be >= 1: {self.transient_fails}")
        if self.latency_s < 0:
            raise ValueError(f"latency_s must be >= 0: {self.latency_s}")

    @classmethod
    def parse(cls, spec: str, *, seed: int = 0) -> "FaultPlan":
        """Build a plan from a ``key=value,key=value`` CLI spec.

        Example: ``"transient=0.1,poison=0.02,oom=0.05,latency=0.1"``.
        Keys: ``transient``, ``poison``, ``oom``, ``latency`` (rates),
        ``latency_s``, ``transient_fails``, ``seed``.  Raises ValueError
        on unknown keys or malformed values -- launchers surface this at
        argument-parse time, not mid-run.
        """
        kw: Dict[str, object] = {"seed": seed}
        aliases = {"transient": "transient_rate", "poison": "poison_rate",
                   "oom": "oom_rate", "latency": "latency_rate"}
        spec = spec.strip()
        if spec:
            for item in spec.split(","):
                if "=" not in item:
                    raise ValueError(
                        f"malformed fault spec item {item!r} "
                        f"(want key=value)")
                key, val = (s.strip() for s in item.split("=", 1))
                field = aliases.get(key, key)
                if field not in {f.name for f in dataclasses.fields(cls)}:
                    raise ValueError(
                        f"unknown fault spec key {key!r}; known: "
                        f"{sorted(aliases) + ['latency_s', 'transient_fails', 'seed']}")
                try:
                    kw[field] = (int(val) if field in
                                 ("seed", "transient_fails") else float(val))
                except ValueError:
                    raise ValueError(
                        f"bad value for fault spec key {key!r}: {val!r}")
        return cls(**kw)  # type: ignore[arg-type]


def _uid_draw(seed: int, kind: str, uid: int) -> float:
    """Uniform [0,1) draw that depends ONLY on (seed, kind, uid).

    ``zlib.crc32`` (not ``hash``) keys the kind: Python's string hash is
    randomized per process, which would break cross-process replay.
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(kind.encode()), uid]))
    return float(rng.random())


class FaultInjector:
    """Realize a :class:`FaultPlan` against a forward and a clock.

    ``wrap(run_batch)`` returns a forward that raises the planned faults
    before delegating; the wrapper declares ``wants_uids`` so the
    scheduler passes the batch's real-row uids (poison/transient decisions
    need them).  ``now()`` wraps the injected clock, adding the skew
    accumulated by latency spikes -- the engine, queue and injector all
    see one consistent (warped) clock domain.
    """

    def __init__(self, plan: FaultPlan,
                 clock: Optional[Callable[[], float]] = None):
        self.plan = plan
        self._clock = clock
        self._skew = 0.0
        # per-call streams (documented schedule-coupled)
        self._call_rng = np.random.default_rng(
            np.random.SeedSequence([plan.seed, 0x0C4115]))
        self._transient_left: Dict[int, int] = {}
        self.injected: Dict[str, int] = {
            "transient": 0, "poison": 0, "oom": 0, "latency": 0}

    # -- per-uid decisions (schedule-independent) ---------------------------

    def is_poison(self, uid: int) -> bool:
        if uid in self.plan.poison_uids:
            return True
        return (self.plan.poison_rate > 0.0 and
                _uid_draw(self.plan.seed, "poison", uid) < self.plan.poison_rate)

    def is_transient(self, uid: int) -> bool:
        return (self.plan.transient_rate > 0.0 and
                _uid_draw(self.plan.seed, "transient", uid)
                < self.plan.transient_rate)

    # -- the wrappers -------------------------------------------------------

    def now(self) -> float:
        """The wrapped clock: base clock + accumulated latency skew."""
        if self._clock is None:
            raise RuntimeError("FaultInjector built without a clock")
        return self._clock() + self._skew

    def check(self, uids: Sequence[int]) -> None:
        """Raise the planned fault for this forward call, if any."""
        for uid in uids:
            if self.is_poison(uid):
                self.injected["poison"] += 1
                raise PoisonFault(
                    f"injected poison fault (uid {uid}, "
                    f"seed {self.plan.seed})")
        for uid in uids:
            if self.is_transient(uid):
                left = self._transient_left.setdefault(
                    uid, self.plan.transient_fails)
                if left > 0:
                    self._transient_left[uid] = left - 1
                    self.injected["transient"] += 1
                    raise TransientFault(
                        f"injected transient fault (uid {uid}, "
                        f"{left - 1} more)")
        if (self.plan.oom_rate > 0.0 and
                float(self._call_rng.random()) < self.plan.oom_rate):
            self.injected["oom"] += 1
            raise OOMFault(
                "injected RESOURCE_EXHAUSTED: out of memory "
                f"(seed {self.plan.seed})")

    def lag(self) -> None:
        """Per-call latency-spike draw; skews the wrapped clock forward."""
        if (self.plan.latency_rate > 0.0 and
                float(self._call_rng.random()) < self.plan.latency_rate):
            self.injected["latency"] += 1
            self._skew += self.plan.latency_s

    def wrap(self, run_batch: Callable) -> Callable:
        """Fault-injecting forward; declares ``wants_uids``.

        Faults fire BEFORE the real forward (a failed step does no work,
        matching how a device OOM aborts the launch); latency spikes fire
        after it (the work happened, slowly).
        """
        inner_wants = getattr(run_batch, "wants_uids", False)

        def injected(batch, *, uids: Sequence[int] = ()):  # noqa: ANN001
            self.check(uids)
            out = (run_batch(batch, uids=uids) if inner_wants
                   else run_batch(batch))
            self.lag()
            return out

        injected.wants_uids = True  # type: ignore[attr-defined]
        return injected

    def stats(self) -> dict:
        return {"seed": self.plan.seed, "injected": dict(self.injected),
                "clock_skew_s": self._skew}
