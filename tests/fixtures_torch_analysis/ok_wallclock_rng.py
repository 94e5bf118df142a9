"""Fixture negative: every draw names its seeded generator."""
import torch


def init_factors(n, r, seed):
    g = torch.Generator().manual_seed(seed)
    U = torch.randn(n, r, generator=g)
    U[0].normal_(generator=g)
    return U
