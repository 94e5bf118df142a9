"""Fixture negative: the jitter default is threaded, not hardcoded."""
import torch

from tpu_als_torch.ops.solve import DEFAULT_JITTER


def regularize(A, jitter=DEFAULT_JITTER):
    return A + jitter * torch.eye(A.shape[-1])
