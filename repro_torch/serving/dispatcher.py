"""Multi-model dispatcher: several engines, one device pool, one policy.

Shen et al.'s resource-partitioning result (PAPERS.md) argues different
layer/model shapes deserve different resource slices.  On a single-host
device pool the slice is TIME: each registered engine (CNN image engines
for AlexNet/VGG16/VGG19, the transformer decode engine -- anything
implementing the small protocol below) keeps its own jit caches, buckets
and scheduler queue, and the dispatcher decides WHICH engine's step runs
next.  The decision is the same deadline discipline the per-engine
scheduler uses, lifted one level: the engine whose most urgent pending
request has the earliest deadline steps first (earliest submit as the
tie-break, registration order last), so an interactive-SLO request on one
model overtakes a batch backlog on another (DESIGN.md 9.5).

Engine protocol (both serving engines implement it):
  * ``has_work()   -> bool``  -- pending requests (or in-flight slots)
  * ``urgency()    -> (deadline, submitted)`` -- earliest pending, +inf pads
  * ``step()``                -- run one batch/decode step
  * ``request_queue``         -- the shared scheduler ``RequestQueue``
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.serving.scheduler import IncompleteRunError, classify_failure


class MultiModelDispatcher:
    """Deadline-ordered time multiplexing of serving engines on one pool.

    Fault isolation: an engine whose ``step()`` raises a non-fatal error
    is marked ``down`` (its requests were already failed TYPED by the
    engine) and SKIPPED from then on -- one failing model never strands
    another model's requests.  Fatal errors (interrupts, contract bugs)
    still propagate.
    """

    def __init__(self):
        self._engines: Dict[str, Any] = {}
        self._order: List[str] = []   # registration order, the last tie-break
        self.steps_by_model: Dict[str, int] = {}
        self.contained: Dict[str, str] = {}   # model -> error that downed it

    def register(self, name: str, engine) -> None:
        if name in self._engines:
            raise ValueError(f"engine {name!r} already registered")
        for attr in ("has_work", "urgency", "step", "request_queue"):
            if not hasattr(engine, attr):
                raise TypeError(
                    f"engine {name!r} lacks {attr!r}; the dispatcher "
                    f"protocol needs has_work/urgency/step/request_queue")
        self._engines[name] = engine
        self._order.append(name)
        self.steps_by_model[name] = 0

    @property
    def models(self) -> Tuple[str, ...]:
        return tuple(self._order)

    def engine(self, name: str):
        return self._engines[name]

    def submit(self, model: str, req, **kw) -> None:
        if model not in self._engines:
            raise KeyError(
                f"unknown model {model!r}; registered: {self._order}")
        self._engines[model].submit(req, **kw)

    @staticmethod
    def _is_up(engine) -> bool:
        """Engines without a health attribute count as healthy."""
        return getattr(engine, "health", "healthy") != "down"

    def health(self) -> Dict[str, str]:
        return {n: getattr(self._engines[n], "health", "healthy")
                for n in self._order}

    def has_work(self) -> bool:
        return any(e.has_work() for e in self._engines.values()
                   if self._is_up(e))

    def next_model(self) -> Optional[str]:
        """The engine the deadline discipline steps next (None when idle).

        ``down`` engines are skipped: their ledgers already hold typed
        ``Failed`` results for everything they were carrying, and stepping
        them would raise ``EngineDownError`` into the serve loop.
        """
        live = [(self._engines[n].urgency(), i, n)
                for i, n in enumerate(self._order)
                if self._is_up(self._engines[n])
                and self._engines[n].has_work()]
        if not live:
            return None
        return min(live)[2]

    def step(self) -> Optional[str]:
        """Step the most urgent engine; returns its model name (None: idle).

        Containment: a non-fatal exception out of the engine's step marks
        that engine ``down`` (requests it was carrying get typed ``Failed``
        results from ``mark_down``) instead of killing the whole serve
        loop; the other engines keep stepping.  Fatal errors and engines
        with no ``mark_down`` hook propagate unchanged.
        """
        name = self.next_model()
        if name is None:
            return None
        eng = self._engines[name]
        try:
            eng.step()
        except BaseException as exc:
            if classify_failure(exc) == "fatal" \
                    or not hasattr(eng, "mark_down"):
                raise
            eng.mark_down(f"step() raised un-contained: {exc}")
            self.contained[name] = f"{type(exc).__name__}: {exc}"
        self.steps_by_model[name] += 1
        return name

    def run(self, max_steps: int = 10_000) -> Dict[str, Dict[int, Any]]:
        """Serve every engine until all drain; raise if max_steps cuts off.

        Returns ``{model: done_ledger}``.  Like the per-engine ``run``s,
        a truncated drain raises :class:`IncompleteRunError` instead of
        silently returning partial ledgers (stranded uids are prefixed
        with their model name).
        """
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        if self.has_work():
            stranded = [f"{n}:{r.uid}" for n in self._order
                        for r in self._engines[n].request_queue.pending]
            done = {n: dict(self._engines[n].request_queue.done)
                    for n in self._order}
            raise IncompleteRunError(done, stranded, max_steps)
        return {n: self._engines[n].request_queue.done for n in self._order}

    def stats(self) -> Dict[str, Any]:
        """Fleet rollup + nested per-model stats.

        The rollup is what an operator pages on: total done/expired/failed
        across every engine (the fleet conservation triple), total retries
        and quarantines, per-engine health, and which engines were downed
        by containment.
        """
        per_model = {}
        for n in self._order:
            eng = self._engines[n]
            per_model[n] = eng.stats() if hasattr(eng, "stats") else {}
            per_model[n]["dispatch_steps"] = self.steps_by_model[n]
        total_done = sum(len(self._engines[n].request_queue.done)
                         for n in self._order)
        total_exp = sum(len(self._engines[n].request_queue.expired)
                        for n in self._order)
        total_failed = sum(len(getattr(self._engines[n].request_queue,
                                       "failed", {}))
                           for n in self._order)
        total_retries = sum(int(per_model[n].get("retries", 0))
                            for n in self._order)
        total_quar = sum(int(per_model[n].get("quarantined", 0))
                         for n in self._order)
        return {"models": list(self._order), "requests_done": total_done,
                "requests_expired": total_exp,
                "requests_failed": total_failed,
                "retries": total_retries,
                "quarantined": total_quar,
                "health": self.health(),
                "contained": dict(self.contained),
                "per_model": per_model}
