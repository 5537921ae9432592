"""Clocks of the port's serving engines.

:func:`with_faults` resolves an engine's ``faults=`` and ``clock=`` the way
the reference's engines do (``repro.serving.engine`` and
``repro.serving.cnn_engine`` each inline it): a :class:`~repro_torch.
serving.faults.FaultPlan` becomes an injector on the engine's clock (the
host's monotonic clock when none is given), and the engine's queue then
runs on the injector's warped clock, so latency spikes skew both alike.
It lives here, and not in ``faults.py``, because that module is kept a
copy of the reference's.

:class:`ManualClock` is a clock that moves only when told to: pass it as
``clock=`` and its ``advance_to`` as ``advance=``, and retry backoff moves
it instead of sleeping, so a chaos run replays the same way on any host.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

from repro_torch.serving.faults import FaultInjector


def with_faults(faults, clock: Optional[Callable[[], float]]
                ) -> Tuple[Optional[FaultInjector],
                           Optional[Callable[[], float]]]:
    """``(injector or None, the clock the engine's queue runs on)``.

    ``faults`` is None, a ``FaultPlan`` or a ``FaultInjector`` (one built
    without a clock gets the engine's).  Without faults the queue runs on
    ``clock`` (None: the scheduler's default).
    """
    if faults is None:
        return None, clock
    inj = (faults if isinstance(faults, FaultInjector)
           else FaultInjector(faults, clock=(clock or time.monotonic)))
    if inj._clock is None:
        inj._clock = clock or time.monotonic
    return inj, inj.now


class ManualClock:
    """A clock at ``t`` seconds that moves only through ``advance_to``."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance_to(self, target: float) -> None:
        self.t = max(self.t, target)
