"""Fixture: TAL007 — a metric literal the port's schema does not declare."""
from tpu_als_torch import obs


def report(n):
    obs.counter("fixture.not_registered", n)
