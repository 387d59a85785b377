"""A virtual monotonic clock for the overload tests of the port against
the JAX package (test_torch_overload.py and the overload cases of
test_torch_sampled_serving.py and test_torch_observability.py).

``virtual_clock(monkeypatch)`` replaces ``time.monotonic`` and
``time.sleep`` with a clock that moves only when something sleeps: a
fault plan's injected delay, a watchdog's retry backoff.  Both packages'
deadlines, watchdogs and plans read the ``time`` module's functions at
call time, so under it every step takes no time, every stall and every
timeout is the schedule's, and the outcome does not depend on how fast
or how loaded the CPU is.  The real clock still runs: the ``cuda`` test
of the watchdog on the card uses it."""
import time


class VirtualClock:
    def __init__(self, start: float = 1000.0):
        self.now = start

    def monotonic(self) -> float:
        return self.now

    def sleep(self, seconds: float):
        self.now += max(0.0, float(seconds))


def virtual_clock(monkeypatch) -> VirtualClock:
    clock = VirtualClock()
    monkeypatch.setattr(time, "monotonic", clock.monotonic)
    monkeypatch.setattr(time, "sleep", clock.sleep)
    return clock
