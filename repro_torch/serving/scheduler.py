"""The one admission queue + SLO-aware continuous microbatcher for every engine.

The port's copy of the JAX package's ``repro/serving/scheduler.py``, which
imports only numpy and the standard library: the port keeps its own copy so
that it never imports the JAX package.  The two copies hold the same
definitions; ``tests/test_torch_cnn.py`` checks that they stay identical
below this docstring.

The serving engines -- :class:`~repro_torch.serving.cnn_engine.
CNNServeEngine` (bucketed microbatching) here, and the transformer decode
engine once it is ported -- admit work through the SAME
:class:`RequestQueue`: admission order, the completion/expiry ledgers and
per-request latency stamps are defined once (DESIGN.md section 9.1).

Scheduling is **continuous and SLO-aware**, not FIFO drain-to-empty:

  * requests carry an optional absolute ``deadline`` (or a named SLO class
    that maps to a latency budget at submit time); admission is
    earliest-deadline-first with FIFO tie-break, so an urgent request
    submitted late overtakes a patient backlog;
  * requests whose deadline has already passed are never served late --
    :meth:`RequestQueue.expire_overdue` rejects them with a typed
    :class:`Expired` result in the ``expired`` ledger;
  * new work can be submitted between (and, from a driver's point of view,
    during) steps -- :meth:`Microbatcher.step` admits whatever is pending
    NOW, it never requires the queue to drain first;
  * bucket selection is a cost model, not a fixed rule: using the
    per-bucket service-time history (``step_log``), :meth:`Microbatcher.
    select_batch` trades padding fraction against the projected step time
    so the most urgent pending deadline is still met (DESIGN.md 9.2).

:class:`Microbatcher` keeps the fixed-shape discipline: the queue admits
into a small set of batch *buckets* (e.g. 1/4/16/64), each microbatch
zero-padded up to its bucket so the jitted forward only ever sees those
shapes -- every steady-state step is a jit cache hit.  Padding and
unpadding bookkeeping lives on host; the forward fn never learns which rows
were real.

**Failure semantics** (DESIGN.md section 9.8) are typed, three-ledger, and
conservation-checked: every submitted request ends in exactly one of
``done`` / ``expired`` / ``failed``.  A forward failure is *classified*
(:func:`classify_failure`): scheduler-invariant bugs
(:class:`BatchContractError`) and ``KeyboardInterrupt``/``SystemExit``
propagate after re-queueing the admitted batch (retrying a contract bug
cannot fix it); transient and OOM-shaped failures are retryable.  With a
:class:`RetryPolicy` the step retries in place -- exponential backoff in
the injected clock domain (never ``time.sleep``; waiting goes through the
``advance=`` hook so warp/fake clocks replay deterministically), capped by
the batch's earliest deadline -- and on repeated failure of a multi-request
batch *bisects* it to isolate the poison request(s): the innocent majority
still serves, the culprit exhausts its attempt budget alone and lands in
the ``failed`` ledger as a typed :class:`Failed` result carrying its
attempt history.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Default latency budgets (seconds) per SLO class.  ``None`` = no deadline
#: (best-effort batch work).  Engines and the queue accept an override dict.
DEFAULT_SLO_BUDGETS: Dict[str, Optional[float]] = {
    "interactive": 0.050,
    "standard": 0.500,
    "batch": None,
}


class BatchContractError(ValueError):
    """A scheduler-internal invariant broke (rows exceed the bucket, wrong
    leading dim from the forward).  NOT a forward failure: retrying cannot
    fix a contract bug, so :func:`classify_failure` marks it fatal and it
    propagates instead of burning the retry budget."""


class EngineDownError(RuntimeError):
    """Submitting to an engine whose health is ``down``.  The engine's
    pending requests were already moved to the ``failed`` ledger; new work
    must go to a healthy engine (the dispatcher skips down engines)."""


#: Substrings that mark an exception as OOM-shaped.  Real device OOMs
#: surface as XlaRuntimeError("RESOURCE_EXHAUSTED: ..."); the fault
#: injector's OOMFault uses the same marker so the classification is one
#: rule for injected and organic failures.
OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "Out of memory",
               "OOM", "oom")


def classify_failure(exc: BaseException) -> str:
    """``'fatal'`` | ``'oom'`` | ``'transient'`` for a forward failure.

    * fatal -- ``KeyboardInterrupt``/``SystemExit`` (the user or runtime is
      tearing the process down) and :class:`BatchContractError` (scheduler
      bugs; the rows-exceed-bucket / wrong-leading-dim checks raise inside
      the same ``try`` as the forward and used to be swallowed into the
      same requeue-and-reraise arm as real forward failures).  Fatal
      failures re-queue the admitted batch (requests are never lost) but
      are NEVER retried.
    * oom -- OOM-shaped (marker match or ``MemoryError``); retryable, and
      engines additionally degrade (shrink buckets / reroute the plan).
    * transient -- everything else; retryable under a :class:`RetryPolicy`.
    """
    if isinstance(exc, (KeyboardInterrupt, SystemExit, BatchContractError)):
        return "fatal"
    if isinstance(exc, MemoryError):
        return "oom"
    msg = str(exc)
    if any(m in msg for m in OOM_MARKERS):
        return "oom"
    return "transient"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/backoff/bisection budget for forward failures.

    ``max_attempts`` bounds per-REQUEST forward attempts (batch failures
    count for every member -- each one burned a real forward); a request
    is only quarantined when it exhausts the budget while serving ALONE,
    so an innocent batch-mate of a poison request is never failed without
    first being isolated from it.  ``backoff(n)`` is exponential in the
    consecutive-failure count, capped at ``backoff_cap`` and (in the step
    loop) at the batch's earliest deadline -- a request never backs off
    past the moment it would expire.  ``bisect_after`` is how many
    consecutive failures a multi-request batch takes before it is split to
    isolate the culprit; once a batch is a bisection *suspect* its halves
    split after a single failure (the culprit is already known to be
    persistent).
    """

    max_attempts: int = 3
    backoff_base: float = 0.002   # seconds, first retry delay
    backoff_mult: float = 2.0
    backoff_cap: float = 0.100
    bisect_after: int = 2

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1: {self.max_attempts}")
        if self.bisect_after < 1:
            raise ValueError(f"bisect_after must be >= 1: {self.bisect_after}")
        if self.backoff_base < 0 or self.backoff_cap < 0:
            raise ValueError("backoff delays must be >= 0")

    def backoff(self, failures: int) -> float:
        """Delay before the next retry after ``failures`` consecutive ones."""
        return min(self.backoff_base * self.backoff_mult ** max(failures - 1, 0),
                   self.backoff_cap)


class IncompleteRunError(RuntimeError):
    """``run()`` hit ``max_steps`` with requests still pending.

    Silently returning ``done`` here is the request-loss trap: callers read
    the return as "complete" and the pending tail is lost.  The partial
    ledger stays reachable on the exception.
    """

    def __init__(self, done: Dict[int, Any], pending_uids: Sequence[int],
                 max_steps: int):
        self.done = done
        self.pending_uids = list(pending_uids)
        self.max_steps = max_steps
        super().__init__(
            f"run() stopped at max_steps={max_steps} with "
            f"{len(self.pending_uids)} request(s) still pending "
            f"(uids {self.pending_uids[:8]}{'...' if len(self.pending_uids) > 8 else ''}); "
            f"{len(done)} completed -- raise max_steps or keep stepping")


@dataclasses.dataclass
class RequestTiming:
    """Host-clock stamps for one request's life cycle."""

    submitted: float
    admitted: Optional[float] = None
    completed: Optional[float] = None
    expired: Optional[float] = None
    failed: Optional[float] = None
    deadline: Optional[float] = None   # absolute, in the queue's clock domain
    slo: Optional[str] = None
    attempts: int = 0                  # forward attempts that included this
    #                                    request and failed (survives requeue)

    @property
    def latency(self) -> Optional[float]:
        if self.completed is None:
            return None
        return self.completed - self.submitted

    @property
    def queue_wait(self) -> Optional[float]:
        if self.admitted is None:
            return None
        return self.admitted - self.submitted

    @property
    def met_deadline(self) -> Optional[bool]:
        """True/False for completed requests with a deadline, else None."""
        if self.completed is None or self.deadline is None:
            return None
        return self.completed <= self.deadline


@dataclasses.dataclass(frozen=True)
class Expired:
    """Typed rejection: the request's deadline passed before admission.

    Handed back INSTEAD of serving late -- a caller that only checks the
    ``done`` ledger cannot mistake an expired request for a lost one, it is
    in ``RequestQueue.expired`` with the deadline it missed.
    """

    uid: int
    deadline: float
    expired_at: float
    slo: Optional[str]
    request: Any


@dataclasses.dataclass(frozen=True)
class Failed:
    """Typed quarantine: the request's forwards kept failing.

    Mirrors :class:`Expired` -- handed back INSTEAD of crash-looping the
    engine.  ``attempts`` is the total failed forward attempts that
    included this request; ``attempt_history`` the ``(time, error)`` pair
    for each of them, so a poison request's record names every failure
    that led to its quarantine.
    """

    uid: int
    error: str                 # the final failure, "Type: message"
    attempts: int
    attempt_history: Tuple[Tuple[float, str], ...]
    failed_at: float
    slo: Optional[str]
    request: Any


def _errstr(exc) -> str:
    return exc if isinstance(exc, str) else f"{type(exc).__name__}: {exc}"


class RequestQueue:
    """Deadline-aware admission queue + completion/expiry ledgers.

    Requests are any objects with a ``uid`` attribute.  ``take`` pops in
    FIFO or earliest-deadline-first order; ``finish`` moves a request to the
    ``done`` ledger; ``expire_overdue`` moves overdue requests to the
    ``expired`` ledger as typed :class:`Expired` results; ``fail`` moves a
    request whose forwards kept failing to the ``failed`` ledger as a typed
    :class:`Failed` result.  Every transition is stamped with the host
    clock so engines get per-request latency accounting for free.  The
    conservation contract: every submitted request ends in exactly one of
    the three ledgers -- ``done + expired + failed == submitted`` once the
    queue drains.  This is the single queue implementation both serving
    engines share.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 slo_budgets: Optional[Dict[str, Optional[float]]] = None):
        self._clock = clock
        self._pending: List[Any] = []
        self.done: Dict[int, Any] = {}
        self.expired: Dict[int, Expired] = {}
        self.failed: Dict[int, Failed] = {}
        self.timing: Dict[int, RequestTiming] = {}
        self._attempt_errors: Dict[int, List[Tuple[float, str]]] = {}
        self.slo_budgets = dict(DEFAULT_SLO_BUDGETS if slo_budgets is None
                                else slo_budgets)

    def now(self) -> float:
        """The queue's clock reading (engines share the clock domain)."""
        return self._clock()

    @property
    def submitted_count(self) -> int:
        return len(self.timing)

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending(self) -> Tuple[Any, ...]:
        return tuple(self._pending)

    @property
    def drained(self) -> bool:
        return not self._pending

    def submit(self, req, *, deadline: Optional[float] = None,
               slo: Optional[str] = None) -> None:
        """Enqueue ``req``; stamp it; resolve its deadline.

        ``deadline`` is ABSOLUTE in this queue's clock domain; ``slo`` names
        a class in ``slo_budgets`` whose budget is added to the submit
        stamp.  An explicit ``deadline`` wins over the class budget.
        Duplicate uids are rejected: silently accepting one used to
        overwrite the first request's ``timing`` entry and later collide in
        the ``done`` ledger, dropping its result and stamps.
        """
        uid = req.uid
        if uid in self.timing:
            state = ("done" if uid in self.done else
                     "expired" if uid in self.expired else
                     "failed" if uid in self.failed else "pending")
            raise ValueError(
                f"duplicate uid {uid}: a request with this uid is already "
                f"{state}; uids identify results in the ledgers and must be "
                f"unique per queue")
        now = self._clock()
        if slo is not None:
            if slo not in self.slo_budgets:
                raise ValueError(
                    f"unknown SLO class {slo!r}; known: "
                    f"{sorted(self.slo_budgets)}")
            if deadline is None and self.slo_budgets[slo] is not None:
                deadline = now + self.slo_budgets[slo]
        self.timing[uid] = RequestTiming(submitted=now, deadline=deadline,
                                         slo=slo)
        self._pending.append(req)

    def _deadline_key(self, req) -> float:
        d = self.timing[req.uid].deadline
        return float("inf") if d is None else d

    def next_deadline(self) -> Optional[float]:
        """Earliest pending deadline, or None if no pending request has one."""
        ds = [self.timing[r.uid].deadline for r in self._pending]
        ds = [d for d in ds if d is not None]
        return min(ds) if ds else None

    def urgency(self) -> Tuple[float, float]:
        """(earliest deadline, earliest submit) over pending -- dispatch key."""
        if not self._pending:
            return (float("inf"), float("inf"))
        return (min(self._deadline_key(r) for r in self._pending),
                min(self.timing[r.uid].submitted for r in self._pending))

    def take(self, max_n: int, *, order: str = "edf") -> List[Any]:
        """Admit up to ``max_n`` requests.

        ``order="edf"`` (the serving default): earliest deadline first,
        submission order as the tie-break -- deadline-less requests sort
        after every deadlined one.  ``order="fifo"``: strict submission
        order (the PR-2 behavior, still used where deadlines don't exist).
        """
        if max_n <= 0:
            return []
        if order == "fifo":
            admitted = self._pending[:max_n]
            del self._pending[:max_n]
        elif order == "edf":
            ranked = sorted(range(len(self._pending)),
                            key=lambda i: (self._deadline_key(self._pending[i]), i))
            chosen = ranked[:max_n]
            admitted = [self._pending[i] for i in chosen]
            chosen_set = set(chosen)
            self._pending = [r for i, r in enumerate(self._pending)
                             if i not in chosen_set]
        else:
            raise ValueError(f"unknown admission order {order!r}")
        now = self._clock()
        for req in admitted:
            self.timing[req.uid].admitted = now
        return admitted

    def expire_overdue(self, now: Optional[float] = None) -> List[Expired]:
        """Reject every pending request whose deadline has passed.

        Each gets a typed :class:`Expired` result in the ``expired`` ledger
        (and an ``expired`` stamp) INSTEAD of being served late.  Returns
        the new rejections.
        """
        now = self._clock() if now is None else now
        out: List[Expired] = []
        keep: List[Any] = []
        for req in self._pending:
            t = self.timing[req.uid]
            if t.deadline is not None and t.deadline <= now:
                t.expired = now
                res = Expired(uid=req.uid, deadline=t.deadline,
                              expired_at=now, slo=t.slo, request=req)
                self.expired[req.uid] = res
                out.append(res)
            else:
                keep.append(req)
        if out:
            self._pending = keep
        return out

    def expire(self, req, now: Optional[float] = None) -> Expired:
        """Expire ONE already-admitted request (deadline passed mid-retry).

        ``expire_overdue`` only sees pending requests; a request admitted
        into a batch that is backing off between retries is in neither
        list, so the retry loop expires it directly -- typed, never lost.
        """
        now = self._clock() if now is None else now
        t = self.timing[req.uid]
        t.expired = now
        res = Expired(uid=req.uid, deadline=t.deadline, expired_at=now,
                      slo=t.slo, request=req)
        self.expired[req.uid] = res
        return res

    def record_attempt(self, uid: int, when: float, exc) -> int:
        """Count one failed forward attempt against ``uid``; returns total.

        Attempt counts live on the timing entry, NOT on the admitted batch,
        so they survive ``requeue_front`` -- a request re-queued by a fatal
        error or served again after a failure keeps its history.
        """
        t = self.timing[uid]
        t.attempts += 1
        self._attempt_errors.setdefault(uid, []).append((when, _errstr(exc)))
        return t.attempts

    def fail(self, req, *, error, now: Optional[float] = None) -> Failed:
        """Quarantine ``req`` with a typed :class:`Failed` result.

        The third ledger: a request whose forwards kept failing is handed
        back with its full attempt history instead of crash-looping the
        engine or silently vanishing.
        """
        now = self._clock() if now is None else now
        t = self.timing[req.uid]
        t.failed = now
        res = Failed(uid=req.uid, error=_errstr(error), attempts=t.attempts,
                     attempt_history=tuple(self._attempt_errors.get(req.uid, ())),
                     failed_at=now, slo=t.slo, request=req)
        self.failed[req.uid] = res
        return res

    def fail_pending(self, error) -> List[Failed]:
        """Fail EVERY pending request (engine going down); returns them."""
        out = [self.fail(req, error=error) for req in self._pending]
        self._pending = []
        return out

    def requeue_front(self, reqs: Sequence[Any]) -> None:
        """Return admitted-but-unserved requests to the HEAD of the queue.

        Used when a forward fails after admission: the requests go back in
        their original relative order ahead of everything newer, and their
        admission stamp is cleared so ``queue_wait`` reflects the admission
        that actually served them.  (Under EDF the next ``take`` re-ranks
        by deadline anyway; front insertion preserves the FIFO tie-break.)
        """
        self._pending[:0] = list(reqs)
        for req in reqs:
            self.timing[req.uid].admitted = None

    def finish(self, req) -> None:
        self.timing[req.uid].completed = self._clock()
        self.done[req.uid] = req

    def latency(self, uid: int) -> Optional[float]:
        return self.timing[uid].latency

    def latencies(self) -> List[float]:
        """Completed-request latencies, in completion order."""
        return [self.timing[uid].latency for uid in self.done]


def wait_until(clock: Callable[[], float], target: float,
               advance: Optional[Callable[[float], None]] = None) -> None:
    """Block until the injected ``clock`` reaches ``target`` (retry backoff).

    With an ``advance`` hook (warp clock, fake test clock) the hook moves
    the clock; otherwise we spin on clock reads (a real monotonic clock
    advances on its own).  Never ``time.sleep`` -- that would decouple
    backoff from the injected clock and break warp-clock replay
    determinism (grep-contract in tests/test_resilience.py).  A frozen
    injected clock with no hook bails after a bounded spin instead of
    hanging.
    """
    if advance is not None:
        advance(target)
    stuck = 0
    last = clock()
    while last < target:
        cur = clock()
        if cur <= last:
            stuck += 1
            if stuck > 100_000:
                break
        else:
            stuck = 0
        last = cur


def select_bucket(pending: int, buckets: Sequence[int]) -> int:
    """Fixed-shape bucket for ``pending`` waiting requests (no history).

    The smallest bucket that fits them all (minimal padding), or the largest
    bucket when more are waiting than any bucket holds (the queue drains at
    full batches until the tail).  ``buckets`` must be sorted ascending.
    This is the history-less fallback :meth:`Microbatcher.select_batch`
    degenerates to before any step has been timed.
    """
    if pending <= 0:
        raise ValueError("select_bucket needs pending >= 1")
    for b in buckets:
        if pending <= b:
            return b
    return buckets[-1]


def pad_batch(rows: List[np.ndarray], bucket: int) -> np.ndarray:
    """Stack ``rows`` and zero-pad the batch axis up to ``bucket``."""
    n = len(rows)
    if n > bucket:
        raise BatchContractError(f"{n} rows exceed bucket {bucket}")
    batch = np.stack(rows, axis=0)
    if n < bucket:
        pad = np.zeros((bucket - n,) + batch.shape[1:], batch.dtype)
        batch = np.concatenate([batch, pad], axis=0)
    return batch


class Microbatcher:
    """SLO-aware continuous batching over a :class:`RequestQueue`.

    Payloads (one ndarray per request, all the same shape) are stacked and
    zero-padded to the selected bucket; the step fn sees only bucket-shaped
    batches, and only the first ``n_real`` output rows are handed back to
    their requests.  Admission is earliest-deadline-first and continuous --
    submit between steps at will; each :meth:`step` first rejects overdue
    requests (typed :class:`Expired` results), then picks the bucket whose
    projected service time still meets the most urgent pending deadline at
    the best real-rows-per-second (DESIGN.md 9.2).  Everything here is host
    bookkeeping -- no device math -- so the scheduling policy is
    unit-testable with a stubbed forward fn.
    """

    #: recent service-time samples per bucket consulted by the projection
    HISTORY_WINDOW = 16

    def __init__(self, buckets: Sequence[int] = (1, 4, 16, 64),
                 clock: Callable[[], float] = time.monotonic,
                 slo_budgets: Optional[Dict[str, Optional[float]]] = None,
                 retry: Optional[RetryPolicy] = None,
                 advance: Optional[Callable[[float], None]] = None,
                 on_fault: Optional[Callable] = None):
        if not buckets:
            raise ValueError("need at least one bucket size")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if self.buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1: {self.buckets}")
        self.queue = RequestQueue(clock, slo_budgets=slo_budgets)
        self._clock = clock
        #: retry/backoff/bisection budget; None keeps the pre-retry contract
        #: exactly (failed forward -> requeue_front -> re-raise)
        self.retry = retry
        #: how backoff waits: ``advance(target)`` moves the injected clock
        #: forward (warp clock / fake clock); without it the loop spins on
        #: clock reads (real monotonic advances by itself) -- never
        #: ``time.sleep``, so warp-clock replays stay deterministic
        self._advance = advance
        #: ``on_fault(kind, exc, uids) -> bool`` observes classified
        #: failures (engines hook health transitions here); returning True
        #: aborts the batch -- its requests are failed typed, not retried
        #: (the engine went down)
        self._on_fault = on_fault
        # padding/throughput bookkeeping
        self.steps = 0
        self.real_rows = 0
        self.padded_rows = 0
        self.bucket_counts: Dict[int, int] = {b: 0 for b in self.buckets}
        self.step_log: List[dict] = []
        # resilience bookkeeping
        self.retries = 0          # retried forward calls
        self.bisections = 0       # batch splits hunting a poison request
        self.quarantined = 0      # requests failed after exhausting attempts
        self.fault_counts: Dict[str, int] = {"transient": 0, "oom": 0}
        # per-bucket service-time history feeding the selection cost model
        self._service_hist: Dict[int, List[float]] = {b: [] for b in self.buckets}

    def submit(self, req, payload: np.ndarray, *,
               deadline: Optional[float] = None,
               slo: Optional[str] = None) -> None:
        req._payload = np.asarray(payload)
        self.queue.submit(req, deadline=deadline, slo=slo)

    # -- SLO-aware batch selection -------------------------------------------

    def record_service(self, bucket: int, seconds: float) -> None:
        """Feed one observed service time into the projection history.

        ``step`` does this for every successful batch; engines also call it
        from ``warmup()`` so the very first scheduling decisions already
        have per-bucket timings instead of flying blind.
        """
        self._service_hist.setdefault(bucket, []).append(float(seconds))

    def service_estimate(self, bucket: int) -> Optional[float]:
        """Projected step time for ``bucket`` -- a p99-flavored bound.

        The max over the recent history window (with <~100 samples per
        bucket the empirical max IS the p99 estimate).  Buckets never timed
        borrow from the nearest measured bucket: flat when borrowing
        downward (a smaller batch is dominated by the same fixed dispatch
        cost, not linearly cheaper), scaled linearly in batch rows when
        borrowing upward (a conservative bound).  With no history at all
        returns None (the cost model then degenerates to smallest-fit).
        """
        hist = self._service_hist.get(bucket)
        if hist:
            return max(hist[-self.HISTORY_WINDOW:])
        known = [(b, max(h[-self.HISTORY_WINDOW:]))
                 for b, h in self._service_hist.items() if h]
        if not known:
            return None
        b0, t0 = min(known, key=lambda bt: abs(bt[0] - bucket))
        return t0 * max(1.0, bucket / b0)

    def select_batch(self, now: Optional[float] = None) -> Tuple[int, int]:
        """Pick ``(bucket, admit_n)`` for the current queue state.

        The cost model trades padding fraction against the projected step
        time: among buckets whose projection still meets the most urgent
        pending deadline, take the one serving the most real rows per
        projected second (padding fraction, then smaller bucket, as
        tie-breaks).  If NO bucket can meet the urgent deadline, serve it
        anyway on the fastest-projected bucket -- minimizing how late it is
        beats maximizing throughput.  With no timing history every bucket
        projects instantaneous and this degenerates to the PR-2
        smallest-fit rule (``select_bucket``).
        """
        n = len(self.queue)
        if n <= 0:
            raise ValueError("select_batch needs a non-empty queue")
        now = self._clock() if now is None else now
        d_min = self.queue.next_deadline()
        feasible: List[Tuple[float, int, float, int]] = []
        fallback: List[Tuple[float, int, int]] = []
        for b in self.buckets:
            m = min(n, b)
            est = self.service_estimate(b) or 0.0
            rate = m / max(est, 1e-9)
            padding = (b - m) / b
            if d_min is None or now + est <= d_min:
                # maximize projected real rows/sec; ties (the linear-borrow
                # estimate makes them exact) prefer more rows per step, then
                # less padding, then the smaller bucket
                feasible.append((rate, m, -padding, -b))
            fallback.append((est, -m, b))
        if feasible:
            rate, m, neg_pad, neg_b = max(feasible)
            return -neg_b, m
        est, neg_m, b = min(fallback)
        return b, -neg_m

    # -- the serve loop -------------------------------------------------------

    def _fit_bucket(self, n: int) -> Optional[int]:
        """Smallest current bucket holding ``n`` rows; None if none fits."""
        for b in self.buckets:
            if b >= n:
                return b
        return None

    def drop_largest_bucket(self) -> Optional[int]:
        """Shrink the bucket set by its largest member (degraded mode).

        Engines call this on OOM-shaped failures: the largest jit shape is
        the memory hog, so retiring it lets the remaining shapes keep
        serving.  Returns the dropped size, or None when only one bucket
        is left (nothing safe to drop).
        """
        if len(self.buckets) <= 1:
            return None
        dropped = self.buckets[-1]
        self.buckets = self.buckets[:-1]
        return dropped

    @staticmethod
    def _call(run_batch: Callable, batch: np.ndarray,
              uids: Tuple[int, ...]) -> np.ndarray:
        """Invoke a forward, passing real-row uids only to wrappers that
        declare ``wants_uids`` (FaultInjector.wrap does; plain engine
        forwards keep the 1-arg signature)."""
        if getattr(run_batch, "wants_uids", False):
            return np.asarray(run_batch(batch, uids=uids))
        return np.asarray(run_batch(batch))

    def _wait_until(self, target: float) -> None:
        wait_until(self._clock, target, self._advance)

    def step(self, run_batch: Callable[[np.ndarray], np.ndarray]
             ) -> List[Tuple[Any, np.ndarray]]:
        """Admit one microbatch (EDF), run it, unpad, finish its requests.

        Overdue requests are rejected first (typed results in
        ``queue.expired``) -- they are never padded into a batch and served
        late.  Returns ``[(request, output_row), ...]`` for the real rows
        only; an empty list when nothing admissible is pending.  With a
        :class:`RetryPolicy` the admitted batch is retried/bisected inside
        the step (see :meth:`_serve`); without one a failed forward
        re-queues the batch at the front and re-raises, exactly the
        pre-retry contract.
        """
        now = self._clock()
        self.queue.expire_overdue(now)
        if len(self.queue) == 0:
            return []
        bucket, admit_n = self.select_batch(now)
        admitted = self.queue.take(admit_n, order="edf")
        return self._serve(admitted, run_batch, bucket=bucket)

    def _serve(self, admitted: List[Any], run_batch: Callable,
               bucket: Optional[int] = None, suspect: bool = False
               ) -> List[Tuple[Any, np.ndarray]]:
        """Run one admitted group to a terminal state for every request.

        Terminal means each request ends in exactly one ledger: ``done``
        (forward succeeded, possibly after retries), ``expired`` (deadline
        passed during backoff), or ``failed`` (attempts exhausted serving
        alone -> quarantined, or the engine gave up via ``on_fault``).
        Retry loop: classify the failure (fatal errors and
        KeyboardInterrupt/SystemExit propagate immediately with the batch
        re-queued), record a per-request attempt, back off on the injected
        clock capped by the earliest admitted deadline, and after
        ``bisect_after`` consecutive failures split the batch in half to
        isolate poison requests -- halves are ``suspect`` and split after a
        single failure, so a poison request is cornered in O(log n) extra
        forwards while innocents serve.
        """
        batch_failures = 0
        while True:
            if not admitted:
                return []
            if bucket is None or bucket not in self.buckets \
                    or bucket < len(admitted):
                bucket = self._fit_bucket(len(admitted))
            if bucket is None:
                # the bucket set shrank (degraded mode) below this group:
                # split until the halves fit -- no failure implied
                mid = (len(admitted) + 1) // 2
                return (self._serve(admitted[:mid], run_batch,
                                    suspect=suspect)
                        + self._serve(admitted[mid:], run_batch,
                                      suspect=suspect))
            batch = pad_batch([r._payload for r in admitted], bucket)
            uids = tuple(r.uid for r in admitted)
            t0 = self._clock()
            try:
                out = self._call(run_batch, batch, uids)
                if out.shape[0] != bucket:
                    raise BatchContractError(
                        f"run_batch returned leading dim {out.shape[0]}, "
                        f"expected bucket {bucket}")
            except BaseException as exc:
                kind = classify_failure(exc)
                if kind == "fatal":
                    # Scheduler-invariant violations and interrupts are not
                    # forward faults: re-queue (no request lost) and
                    # propagate -- never retried, never counted.
                    self.queue.requeue_front(admitted)
                    raise
                now = self._clock()
                batch_failures += 1
                self.fault_counts[kind] = self.fault_counts.get(kind, 0) + 1
                for req in admitted:
                    self.queue.record_attempt(req.uid, now, exc)
                if self._on_fault is not None \
                        and self._on_fault(kind, exc, uids):
                    # the engine gave up (went down / cannot degrade
                    # further): terminal typed failures, no silent loss
                    for req in admitted:
                        self.queue.fail(req, error=exc, now=now)
                    return []
                if self.retry is None:
                    # pre-retry contract: front-requeue + re-raise
                    self.queue.requeue_front(admitted)
                    raise
                if len(admitted) == 1:
                    req = admitted[0]
                    if self.queue.timing[req.uid].attempts \
                            >= self.retry.max_attempts:
                        # exhausted its budget serving ALONE -- only now is
                        # the failure attributable to the request itself
                        self.queue.fail(req, error=exc, now=now)
                        self.quarantined += 1
                        return []
                elif batch_failures >= (1 if suspect else
                                        self.retry.bisect_after):
                    # repeated whole-batch failure: hunt the poison request
                    # by bisection; innocents in the other half still serve
                    self.bisections += 1
                    mid = len(admitted) // 2
                    return (self._serve(admitted[:mid], run_batch,
                                        suspect=True)
                            + self._serve(admitted[mid:], run_batch,
                                          suspect=True))
                self.retries += 1
                target = now + self.retry.backoff(batch_failures)
                deadlines = [self.queue.timing[r.uid].deadline
                             for r in admitted
                             if self.queue.timing[r.uid].deadline is not None]
                if deadlines:
                    # never back off past the most urgent admitted deadline
                    target = min(target, min(deadlines))
                self._wait_until(target)
                now = self._clock()
                still = []
                for req in admitted:
                    # same overdue rule as expire_overdue (deadline <= now):
                    # a backoff capped AT the deadline expires the request
                    # the moment the wait lands there
                    d = self.queue.timing[req.uid].deadline
                    if d is not None and d <= now:
                        self.queue.expire(req, now)
                    else:
                        still.append(req)
                admitted = still
                continue
            dt = self._clock() - t0
            self.steps += 1
            self.real_rows += len(admitted)
            self.padded_rows += bucket - len(admitted)
            self.bucket_counts[bucket] = \
                self.bucket_counts.get(bucket, 0) + 1
            self.step_log.append({"bucket": bucket, "real": len(admitted),
                                  "seconds": dt})
            self.record_service(bucket, dt)
            results = []
            for i, req in enumerate(admitted):
                del req._payload  # long-lived engines must not retain inputs
                self.queue.finish(req)
                results.append((req, out[i]))
            return results

    def run(self, run_batch: Callable[[np.ndarray], np.ndarray],
            max_steps: int = 10_000) -> Dict[int, Any]:
        """Drain the queue; raise :class:`IncompleteRunError` if it can't.

        Convenience for closed request sets (benchmarks, tests).  Continuous
        serving drives :meth:`step` directly and submits between steps.
        Hitting ``max_steps`` with requests still pending raises -- the old
        silent ``return done`` made callers read a truncated run as
        complete, losing the pending tail.
        """
        steps = 0
        while len(self.queue) and steps < max_steps:
            self.step(run_batch)
            steps += 1
        if len(self.queue):
            raise IncompleteRunError(
                self.queue.done, [r.uid for r in self.queue.pending],
                max_steps)
        return self.queue.done

    # -- accounting ---------------------------------------------------------

    @property
    def padding_fraction(self) -> float:
        total = self.real_rows + self.padded_rows
        return self.padded_rows / total if total else 0.0

    def stats(self) -> dict:
        lats = [v for v in self.queue.latencies() if v is not None]
        wall = sum(s["seconds"] for s in self.step_log)
        met = [self.queue.timing[uid].met_deadline for uid in self.queue.done]
        misses = sum(1 for m in met if m is False)
        in_time = len(lats) - misses
        return {
            "requests_done": len(self.queue.done),
            "requests_expired": len(self.queue.expired),
            "requests_failed": len(self.queue.failed),
            "retries": self.retries,
            "bisections": self.bisections,
            "quarantined": self.quarantined,
            "fault_counts": dict(self.fault_counts),
            "deadline_misses": misses,
            "steps": self.steps,
            "real_rows": self.real_rows,
            "padded_rows": self.padded_rows,
            "padding_fraction": self.padding_fraction,
            "bucket_counts": dict(self.bucket_counts),
            "batch_seconds": wall,
            "throughput_rps": (self.real_rows / wall) if wall > 0 else 0.0,
            "goodput_rps": (in_time / wall) if wall > 0 else 0.0,
            "latency_mean_s": float(np.mean(lats)) if lats else 0.0,
            "latency_p50_s": float(np.percentile(lats, 50)) if lats else 0.0,
            "latency_p95_s": float(np.percentile(lats, 95)) if lats else 0.0,
            "latency_p99_s": float(np.percentile(lats, 99)) if lats else 0.0,
        }
