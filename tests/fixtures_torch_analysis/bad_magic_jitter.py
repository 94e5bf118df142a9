"""Fixture: TAL009 — hardcoded 1e-6 jitter literal."""
import torch


def regularize(A, jitter=1e-6):
    return A + jitter * torch.eye(A.shape[-1])
