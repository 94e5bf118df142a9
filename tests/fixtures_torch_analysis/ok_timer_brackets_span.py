"""Fixture negative: the clock starts inside the span body."""
import time

from tpu_als_torch import obs


def timed(work):
    with obs.span("fixture.work"):
        t0 = time.perf_counter()
        work()
        return time.perf_counter() - t0
