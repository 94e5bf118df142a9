"""Fixture: TAL010.  Deliberately stdlib-only — except it isn't."""
import torch


def probe():
    import jax

    return jax.__name__, torch.__name__
