"""Fixture: TAL005 — low precision and TF32 with no dtype gate."""
import torch


def shrink(x):
    return x.half() * 2.0


def scores(U, V):
    torch.backends.cuda.matmul.allow_tf32 = True
    return U.to(torch.bfloat16) @ V.to(torch.bfloat16).T
