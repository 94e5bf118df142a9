"""Fixture: TAL011 — the clock brackets the span enter/exit emission."""
import time

from tpu_als_torch import obs


def timed(work):
    t0 = time.perf_counter()
    with obs.span("fixture.work"):
        work()
    return time.perf_counter() - t0
