"""Fixture: TAL012 — suppressions without a reason / of unknown rules."""
import torch


def draw(n):
    return torch.randn(n)  # tal: disable=wallclock-rng


def other(x):
    # tal: disable=not-a-rule -- the rule name does not exist
    return x
