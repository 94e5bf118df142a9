"""Fixture: TAL003 — random draws from torch's global RNG."""
import torch


def init_factors(n, r):
    torch.manual_seed(0)
    U = torch.randn(n, r)
    U[0].normal_()
    return U
