"""Fixture negative: the cast is gated on (and restores) the input's
dtype, and TF32 stays off."""
import torch


def shrink(x):
    orig = x.dtype
    y = x.to(torch.bfloat16) * 2.0
    return y.to(orig)


def pin():
    torch.backends.cuda.matmul.allow_tf32 = False
