"""The port's normal-equation traffic audit (``perf/ne_audit.py``)
against ``tpu_als.perf.ne_audit``.

- ``gather_out_bytes``: the port's unfused build (``V[cols]`` + the
  normal equations) gathers exactly the reference's einsum build's bytes
  at the same shapes, one gather of n·w·r·4; the port's whole unfused
  half-step of a bucket the same.  (On the CPU the fused routes run
  their kernels' plain versions, which gather; that they gather nothing
  is held on the card, ``chip_smoke.py`` phase 11.)
- ``kernel_cost_bytes``: K3's, K4's and K7's wrappers declare the
  roofline's closed forms at their shapes, f32 and bf16, one
  declaration a call; a half-step whose K3 bucket is cut into chunks
  declares the closed form at the whole bucket (the forms are linear).
Every comparison is exact (integers).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_als.ops.solve import normal_eq_explicit as j_ne_explicit
from tpu_als.ops.solve import normal_eq_implicit as j_ne_implicit
from tpu_als.perf.ne_audit import gather_out_bytes as j_gather_out_bytes
from tpu_als_torch.core import als as tals
from tpu_als_torch.core.ratings import build_csr_buckets
from tpu_als_torch.ops import cuda_gather_ne as gne
from tpu_als_torch.ops.solve import compute_yty, normal_eq_explicit
from tpu_als_torch.ops.solve import normal_eq_implicit
from tpu_als_torch.perf.ne_audit import gather_out_bytes, kernel_cost_bytes
from tpu_als_torch.perf.roofline import (fused_ne_kernel_bytes,
                                         fused_ring_kernel_bytes,
                                         fused_solve_kernel_bytes)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny tensors: under the suite's
    workers a thread pool per small op mostly waits for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n=48, w=40, r=24, N=300):
    rng = np.random.default_rng(7)
    return (rng.normal(size=(N, r)).astype(np.float32),
            rng.integers(0, N, size=(n, w)).astype(np.int32),
            rng.normal(size=(n, w)).astype(np.float32),
            (rng.random((n, w)) < 0.8).astype(np.float32))


@pytest.mark.parametrize("implicit", [False, True])
def test_unfused_gather_bytes_equal_the_reference(implicit):
    V, cols, vals, mask = _problem()
    n, w = cols.shape
    r = V.shape[1]
    Y = np.eye(r, dtype=np.float32)
    if implicit:
        def jfn(V, c, v, m):
            return j_ne_implicit(V[c], v, m, 0.1, 4.0, jnp.asarray(Y))

        def tfn(V, c, v, m):
            return normal_eq_implicit(V[c.long()], v, m, 0.1, 4.0,
                                      torch.from_numpy(Y))
    else:
        def jfn(V, c, v, m):
            return j_ne_explicit(V[c], v, m, 0.1)

        def tfn(V, c, v, m):
            return normal_eq_explicit(V[c.long()], v, m, 0.1)
    ref = j_gather_out_bytes(jfn, *(jnp.asarray(a) for a in
                                    (V, cols, vals, mask)))
    got = gather_out_bytes(tfn, *(torch.from_numpy(a) for a in
                                  (V, cols, vals, mask)))
    assert got == ref == (n * w * r * 4, 1)


def _buckets(nU=150, nI=50, nnz=2000):
    rng = np.random.default_rng(3)
    u = np.minimum(rng.zipf(1.3, nnz), nU) - 1
    i = np.minimum(rng.zipf(1.2, nnz), nI) - 1
    r = rng.uniform(0.5, 5.0, nnz).astype(np.float32)
    return build_csr_buckets(i, u, r, nI, min_width=4,
                             chunk_elems=1 << 10).to("cpu"), nU, nI


@pytest.mark.parametrize("implicit", [False, True])
def test_unfused_half_step_gathers_the_bucket_once(implicit):
    ib, nU, nI = _buckets()
    r = 8
    U = torch.randn(nU, r)
    cfg = tals.AlsConfig(rank=r, implicit_prefs=implicit,
                         solve_backend="unfused")
    yty = compute_yty(U) if implicit else None
    for b in ib:
        n, w = b.cols.shape

        def half(b=b):
            return tals.local_half_step(U, [b], nI, cfg, yty)

        chunks = -(-n // tals._chunk_rows("einsum+pallas_lanes", n, w, r,
                                          1 << 10))
        assert gather_out_bytes(half) == (n * w * r * 4, chunks)
        assert kernel_cost_bytes(half) == (0, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("implicit", [False, True])
def test_wrappers_declare_the_closed_forms(implicit, dtype):
    V, cols, vals, mask = (torch.from_numpy(a) for a in _problem())
    V, vals, mask = V.to(dtype), vals.to(dtype), mask.to(dtype)
    (n, w), r, db = cols.shape, V.shape[1], V.element_size()
    Y = torch.eye(r)
    if implicit:
        k3 = lambda: gne.gather_normal_eq_implicit(  # noqa: E731
            V, cols, vals, mask, 0.1, 4.0, Y)
        k4 = lambda: gne.gather_fused_solve_implicit(  # noqa: E731
            V, cols, vals, mask, 0.1, 4.0, Y)
    else:
        k3 = lambda: gne.gather_normal_eq_explicit(  # noqa: E731
            V, cols, vals, mask, 0.1)
        k4 = lambda: gne.gather_fused_solve_explicit(  # noqa: E731
            V, cols, vals, mask, 0.1)
    assert kernel_cost_bytes(k3) == (fused_ne_kernel_bytes(n * w, n, r, db),
                                     1)
    assert kernel_cost_bytes(k4) == (
        fused_solve_kernel_bytes(n * w, n, r, db), 1)
    # K7: D owners' rows over S source shards of `per` rows; the logical
    # shards share one device, so no ring payload crosses a link
    D = S = 3
    per = V.shape[0] // S
    Vs = V[:S * per].reshape(S, per, r).contiguous()
    rc = (cols[:D * 8].reshape(D, 1, 8, w) % per).expand(
        D, S, 8, w).contiguous()
    rv, rm = (t[:D * 8].reshape(D, 1, 8, w).expand(D, S, 8, w).contiguous()
              for t in (vals, mask))
    k7 = (lambda: gne.gather_fused_ring_implicit(  # noqa: E731
        Vs, rc, rv, rm, 0.1, 4.0, Y)) if implicit else \
        (lambda: gne.gather_fused_ring_explicit(  # noqa: E731
            Vs, rc, rv, rm, 0.1))
    assert kernel_cost_bytes(k7) == (
        fused_ring_kernel_bytes(D * S * 8 * w, D * 8, r, db, 0), 1)



def test_wrappers_declare_only_under_the_audit():
    # outside kernel_cost_bytes the wrappers keep no books; an audit
    # inside another counts its own calls, and the outer one goes on
    V, cols, vals, mask = (torch.from_numpy(a) for a in _problem())
    (n, w), r = cols.shape, V.shape[1]
    k3 = lambda: gne.gather_normal_eq_explicit(  # noqa: E731
        V, cols, vals, mask, 0.1)
    k3()
    assert gne.COST is None
    inner = []

    def outer():
        k3()
        inner.append(kernel_cost_bytes(k3))
        k3()

    one = fused_ne_kernel_bytes(n * w, n, r, 4)
    assert kernel_cost_bytes(outer) == (2 * one, 2)
    assert inner == [(one, 1)] and gne.COST is None

def test_chunked_k3_half_step_declares_the_whole_bucket(monkeypatch):
    monkeypatch.setattr(tals, "SPLIT_WIDTH", 16)
    monkeypatch.setattr(tals, "_MEM_ELEMS", 4 * 8 * 8)   # 4 rows a chunk
    ib, nU, nI = _buckets()
    r = 8
    U = torch.randn(nU, r)
    cfg = tals.AlsConfig(rank=r, implicit_prefs=True)
    yty = compute_yty(U)
    wide = [b for b in ib if b.width > 16]
    assert wide and any(b.cols.shape[0] > 4 for b in wide)
    for b in wide:
        n, w = b.cols.shape
        got = kernel_cost_bytes(
            lambda b=b: tals.local_half_step(U, [b], nI, cfg, yty))
        assert got == (fused_ne_kernel_bytes(n * w, n, r, 4),
                       -(-n // tals._chunk_rows(
                           "gatherfused+pallas_cholesky", n, w, r, 1 << 19)))
    narrow = dataclasses.replace(cfg, solve_backend="gather_fused_solve")
    b = ib[0]
    n, w = b.cols.shape
    assert kernel_cost_bytes(lambda: tals.local_half_step(
        U, [b], nI, narrow, yty)) == (fused_solve_kernel_bytes(n * w, n, r, 4),
                                      1)
