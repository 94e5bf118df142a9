"""Fixture negative: a real finding suppressed with a reason."""
import torch


def draw(n):
    # tal: disable=wallclock-rng -- fixture: the global draw IS the point
    return torch.randn(n)
