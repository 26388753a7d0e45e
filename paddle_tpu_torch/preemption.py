"""Graceful preemption handling (SIGTERM).

Counterpart of ``paddle_tpu.preemption``. A scheduler's preemption
warning is a SIGTERM with a short grace window. :class:`PreemptionGuard`
turns it into a cooperative request: the handler only sets a flag; the
training loop checks the flag at step boundaries, finishes the step in
flight, forces a final *synchronous* checkpoint, and then calls
:meth:`PreemptionGuard.reraise`, which restores the previous handler
chain and re-delivers the signal, so the process still dies with the
SIGTERM wait status the scheduler expects. A preempted run therefore
resumes from the step it died at.

The first notice a guard catches counts in ``preemptions_total`` and
leaves a ``preemption_notice`` flight event, as in the JAX package.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Optional, Tuple

from .observability import flight as _flight
from .observability import metrics as _metrics

__all__ = ["PreemptedError", "PreemptionGuard", "guard"]


class PreemptedError(RuntimeError):
    """Raised by :meth:`PreemptionGuard.reraise` when re-delivering the
    signal did not end the process (a chained handler swallowed it), so
    that outer loops unwind, run their own final saves and re-raise in
    turn."""


def _note_preempted(signum: int) -> None:
    _metrics.counter(
        "preemptions_total",
        "SIGTERM preemption notices caught by a preemption guard "
        "(graceful: finish step, checkpoint, re-raise)",
        always=True).inc()
    _flight.record("preemption_notice", force=True, signum=int(signum))


class PreemptionGuard:
    """Context manager that turns SIGTERM into a checked flag::

        with preemption.guard() as g:
            for step in steps:
                run(step)
                if g.preempted:
                    checkpoint_now()
                    g.reraise()   # dies with the SIGTERM wait status

    A handler can only be installed from the main thread; in any other
    thread the guard is inert (``preempted`` stays False), so library
    code can use it unconditionally.
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,)
                 ) -> None:
        self._signals = tuple(signals)
        self._prev: dict = {}
        self._installed = False
        self._flag = threading.Event()
        self.signum: Optional[int] = None

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    @property
    def active(self) -> bool:
        """Whether the handlers are installed (main thread)."""
        return self._installed

    def _handler(self, signum, frame) -> None:
        self.signum = int(signum)
        if not self._flag.is_set():
            self._flag.set()
            _note_preempted(signum)

    def __enter__(self) -> "PreemptionGuard":
        try:
            for sig in self._signals:
                self._prev[sig] = signal.signal(sig, self._handler)
            self._installed = True
        except (ValueError, OSError):  # not the main thread: stay inert
            self._restore()
        return self

    def __exit__(self, *exc) -> bool:
        self._restore()
        return False

    def _restore(self) -> None:
        for sig, prev in list(self._prev.items()):
            try:
                signal.signal(sig, prev if prev is not None
                              else signal.SIG_DFL)
            except (ValueError, OSError):
                pass  # off the main thread; the guard is exiting anyway
        self._prev.clear()
        self._installed = False

    def reraise(self) -> None:
        """Restores the previous handler chain and re-delivers the
        signal: the process must still die with the right wait status.
        Raises :class:`PreemptedError` if a chained handler swallowed
        it."""
        signum = self.signum or self._signals[0]
        self._restore()
        os.kill(os.getpid(), signum)
        # reached only if a chained Python handler caught the re-delivery
        # (an outer guard): unwind by exception
        raise PreemptedError(f"preempted by signal {signum}")


def guard(signals: Tuple[int, ...] = (signal.SIGTERM,)
          ) -> PreemptionGuard:
    """The spelling the training loops use."""
    return PreemptionGuard(signals)
