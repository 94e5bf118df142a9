"""Fixture negative: a declared counter, used as its declared kind."""
from tpu_als_torch import obs


def report(n):
    obs.counter("train.rollbacks", n)
