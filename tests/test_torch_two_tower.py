"""The port's two-tower model (``tpu_als_torch.models.two_tower``) against
the reference's (``tpu_als.models.two_tower``) on the same numpy inputs,
both on the CPU.

Tolerances, each stated where it is used:

- representations: 1e-6 absolute (unit vectors; the two programs round
  the tower's products and the norm differently, measured ~1e-7);
- loss and gradients (``jax.value_and_grad`` against autograd): the loss
  to 1e-6 relative, each gradient entry to 1e-5 of the largest entry of
  its leaf (measured ~1e-7);
- training: ``optax.adam`` and ``torch.optim.Adam`` share their defaults
  and put eps outside the square root, but apply the bias correction in
  different orders, so they differ in the last ulp, and Adam's
  normalisation turns such a difference in a near-zero gradient into an
  update of up to ~lr (1e-3) in either direction.  Measured over the
  three configurations below (3 epochs of 4 steps from one init): epoch
  losses within 2e-6 (3e-7 relative) and parameters within 2.4e-7.  The
  bands: epoch losses to 1e-5 relative, parameters to 2e-5 absolute,
  ~100x the drift measured and 50x below one step of lr;
- ``embed_lr_scale=0.0`` keeps the tables bitwise the warm start, as the
  reference's ``optax.set_to_zero`` does;
- ``ban_lists``, ``log_popularity`` and ``serving_bias``: bitwise;
- ``recall_at_k`` on the same parameters: equal (a share of hits);
- saves: either package loads the other's leaves bitwise.

The reference trains from ``split(PRNGKey(seed))[1]``; the tests rebuild
exactly that init with its own ``init_params`` and hand it to the port
(``train_two_tower(init=...)``, ``convert.two_tower_from_arrays``),
since torch cannot draw ``jax.random``'s bits.  Three reference
trainings in all, at ``tests/test_two_tower.py``'s 60 x 40 scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_ratings
from tpu_als.models import two_tower as J
from tpu_als_torch.convert import two_tower_from_arrays
from tpu_als_torch.models import two_tower as T

NU, NI = 60, 40
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
REPR_ATOL = 1e-6
CONFIGS = {
    "default": dict(embed_dim=8, hidden=(16,), out_dim=8),
    "frozen": dict(embed_dim=4, hidden=(16,), out_dim=4,
                   embed_lr_scale=0.0),
    "slow_linear": dict(embed_dim=8, hidden=(), out_dim=8,
                        embed_lr_scale=0.1),
}


def _interactions():
    rng = np.random.default_rng(0)
    u, i, r, Us, Vs = make_ratings(rng, NU, NI, rank=4, density=0.2)
    pos = r > np.quantile(r, 0.5)
    return u[pos], i[pos], Us, Vs


def _cfgs(**kw):
    base = dict(epochs=3, batch_size=64, seed=3, **kw)
    return J.TwoTowerConfig(**base), T.TwoTowerConfig(**base)


def _ref_init(cfg, warm):
    """The reference's own init inside ``train_two_tower``."""
    _, kinit = jax.random.split(jax.random.PRNGKey(cfg.seed))
    return jax.tree.map(np.asarray,
                        J.init_params(kinit, NU, NI, cfg, *warm))


def two_tower_to_arrays(model):
    """The reference pytree of a port ``TwoTower``, as numpy arrays."""
    def host(x):
        return x.detach().cpu().numpy()

    def tower(t):
        return [{"w": host(lyr.weight.T), "b": host(lyr.bias)}
                for lyr in t.layers]

    return {"user_embed": host(model.user_embed),
            "item_embed": host(model.item_embed),
            "user_tower": tower(model.user_tower),
            "item_tower": tower(model.item_tower)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def assert_trees_close(got, ref, atol):
    for (path, g), (_, r) in zip(_flat(got), _flat(ref), strict=True):
        np.testing.assert_allclose(g, r, rtol=0, atol=atol,
                                   err_msg=str(path))


@pytest.fixture(scope="module")
def trained():
    """Each configuration trained by both packages from one init, with
    their epoch losses."""
    u, i, Us, Vs = _interactions()
    out = {}
    for name, kw in CONFIGS.items():
        jc, tc = _cfgs(**kw)
        warm = (Us, Vs)
        init = _ref_init(jc, warm)
        jl, tl = [], []
        pj = J.train_two_tower(u, i, NU, NI, jc, *warm,
                               callback=lambda e, l, p: jl.append(l))
        pt = T.train_two_tower(
            u, i, NU, NI, tc, callback=lambda e, l, p: tl.append(l),
            init=two_tower_from_arrays(init, tc, device="cpu"),
            device="cpu")
        out[name] = dict(ref=_np(pj), port=pt, init=init, ref_loss=jl,
                         port_loss=tl, cfgs=(jc, tc))
    return out


def test_converter_round_trip():
    jc, tc = _cfgs(**CONFIGS["default"])
    init = _ref_init(jc, (None, None))
    m = two_tower_from_arrays(init, device="cpu")
    assert m.cfg.embed_dim == 8 and m.cfg.hidden == (16,)
    back = two_tower_to_arrays(m)
    for (path, g), (_, r) in zip(_flat(back), _flat(init), strict=True):
        np.testing.assert_array_equal(g, r, err_msg=str(path))
    # the leaves in the reference's tree_flatten order and layout
    leaves = [x.detach().numpy() for x in m.leaves()]
    for g, r in zip(leaves, jax.tree_util.tree_leaves(init), strict=True):
        np.testing.assert_array_equal(g, r)


def test_init_params_warm_start_and_identity_towers():
    _, _, Us, Vs = _interactions()
    cfg = T.TwoTowerConfig(embed_dim=6, hidden=(16,), out_dim=6, seed=2)
    a = T.init_params(NU, NI, cfg, Us, Vs, device="cpu")
    b = T.init_params(NU, NI, cfg, Us, Vs, device="cpu")
    for x, y in zip(a.leaves(), b.leaves(), strict=True):
        assert torch.equal(x, y)   # a seeded draw
    np.testing.assert_array_equal(a.user_embed.detach()[:, :4].numpy(), Us)
    np.testing.assert_array_equal(a.item_embed.detach()[:, :4].numpy(), Vs)
    for tower in (a.user_tower, a.item_tower):
        assert not tower.layers[-1].weight.abs().sum()
        assert tower.layers[0].weight.abs().sum() > 0
    # the residual makes the towers the identity (normalized) at init
    e = a.user_embed.detach()[:5]
    np.testing.assert_allclose(
        T.user_repr(a, torch.arange(5)).detach().numpy(),
        (e / e.norm(dim=1, keepdim=True)).numpy(), rtol=0, atol=REPR_ATOL)


def test_representations_match():
    jc, _ = _cfgs(**CONFIGS["default"])
    u, i, Us, Vs = _interactions()
    p = _ref_init(jc, (Us, Vs))
    rng = np.random.default_rng(1)
    for lyr in p["user_tower"] + p["item_tower"]:   # non-identity towers
        lyr["w"] = rng.normal(0, 0.3, lyr["w"].shape).astype(np.float32)
        lyr["b"] = rng.normal(0, 0.1, lyr["b"].shape).astype(np.float32)
    m = two_tower_from_arrays(p, device="cpu")
    with torch.no_grad():
        zu = T.user_repr(m, torch.arange(NU)).numpy()
        zi = T.item_repr(m, torch.arange(NI)).numpy()
    np.testing.assert_allclose(zu, J.user_repr(p, jnp.arange(NU)),
                               rtol=0, atol=REPR_ATOL)
    np.testing.assert_allclose(zi, J.item_repr(p, jnp.arange(NI)),
                               rtol=0, atol=REPR_ATOL)


def _port_grads(m):
    def tower(t):
        return [{"w": lyr.weight.grad.T.numpy(), "b": lyr.bias.grad.numpy()}
                for lyr in t.layers]

    return {"user_embed": m.user_embed.grad.numpy(),
            "item_embed": m.item_embed.grad.numpy(),
            "user_tower": tower(m.user_tower),
            "item_tower": tower(m.item_tower)}


@pytest.mark.parametrize("logq", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_loss_and_gradients_match(logq, weighted):
    jc, _ = _cfgs(**CONFIGS["default"])
    u, i, Us, Vs = _interactions()
    p = _ref_init(jc, (Us, Vs))
    rng = np.random.default_rng(2)
    for lyr in p["user_tower"] + p["item_tower"]:
        lyr["w"] = rng.normal(0, 0.3, lyr["w"].shape).astype(np.float32)
    sel = rng.choice(len(u), 48, replace=False)
    ub, ib = u[sel], i[sel]
    w = (rng.integers(0, 3, 48).astype(np.float32) if weighted
         else np.ones(48, np.float32))
    log_q = (J.log_popularity(np.bincount(i, minlength=NI)).astype(
        np.float32) if logq else None)
    ref_loss, ref_g = jax.value_and_grad(J.in_batch_softmax_loss)(
        p, jnp.asarray(ub), jnp.asarray(ib), jnp.asarray(w), 0.1,
        None if log_q is None else jnp.asarray(log_q))
    m = two_tower_from_arrays(p, device="cpu")
    loss = T.in_batch_softmax_loss(
        m, torch.from_numpy(ub), torch.from_numpy(ib), torch.from_numpy(w),
        0.1, None if log_q is None else torch.from_numpy(log_q))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    for (path, g), (_, r) in zip(_flat(_port_grads(m)), _flat(_np(ref_g)),
                                 strict=True):
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(),
                                   err_msg=str(path))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_training_matches_from_the_same_init(trained, name):
    t = trained[name]
    assert len(t["port_loss"]) == len(t["ref_loss"]) == 3
    np.testing.assert_allclose(t["port_loss"], t["ref_loss"],
                               rtol=LOSS_RTOL)
    assert_trees_close(two_tower_to_arrays(t["port"]), t["ref"], PARAM_ATOL)
    # the towers moved (a real comparison, not of two inits)
    moved = np.abs(t["ref"]["user_tower"][0]["w"]
                   - t["init"]["user_tower"][0]["w"]).max()
    assert moved > 100 * PARAM_ATOL


def test_frozen_tables_stay_bitwise_the_warm_start(trained):
    t = trained["frozen"]
    got = two_tower_to_arrays(t["port"])
    u, i, Us, Vs = _interactions()
    for key, warm in (("user_embed", Us), ("item_embed", Vs)):
        np.testing.assert_array_equal(got[key], t["init"][key])
        np.testing.assert_array_equal(got[key], t["ref"][key])
        np.testing.assert_array_equal(got[key][:, :4], warm)


def test_slow_tables_drift_less_than_full(trained):
    """embed_lr_scale 0.1 is a second Adam at lr/10 on the tables."""
    t = trained["slow_linear"]
    drift = np.abs(two_tower_to_arrays(t["port"])["user_embed"]
                   - t["init"]["user_embed"]).max()
    assert 0 < drift < 3 * 1e-3 * 0.1 * 12   # 12 steps at lr·scale


def test_numpy_helpers_bitwise():
    rng = np.random.default_rng(4)
    users = np.unique(rng.integers(0, 50, 40))
    tu, ti = rng.integers(0, 60, 300), rng.integers(0, 40, 300)
    for a, b in zip(T.ban_lists(users, tu, ti, 7),
                    J.ban_lists(users, tu, ti, 7), strict=True):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    counts = np.bincount(ti, minlength=45)
    np.testing.assert_array_equal(T.log_popularity(counts),
                                  J.log_popularity(counts))
    a, b = T.serving_bias(counts, 0.1), J.serving_bias(counts, 0.1)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype == np.float32


@pytest.mark.parametrize("mode", ["unfiltered", "filtered", "bias",
                                  "filtered_bias"])
def test_recall_equals_reference_on_the_same_parameters(trained, mode):
    t = trained["default"]
    u, i, _, _ = _interactions()
    m = two_tower_from_arrays(t["ref"], device="cpu")
    rng = np.random.default_rng(5)
    test = rng.random(len(u)) < 0.3
    kw = {}
    if mode.startswith("filtered"):
        # user_batch 16 spreads the bans over four batches
        kw.update(exclude=(u[~test], i[~test]), user_batch=16)
    if mode.endswith("bias"):
        kw["item_bias"] = J.serving_bias(np.bincount(i, minlength=NI), 0.1)
    for k in (1, 5):
        got = T.recall_at_k(m, u[test], i[test], k=k, **kw)
        want = J.recall_at_k(t["ref"], u[test], i[test], k=k, **kw)
        assert got == want, (mode, k, got, want)
    assert 0 < got < 1


def test_filtered_recall_bans_train_items():
    """The reference's hand case: user 0's top item is a train item."""
    Uf = np.zeros((3, 4), np.float32)
    Vf = np.zeros((5, 4), np.float32)
    Uf[0, 0], Vf[0, 0], Vf[1, 0] = 1.0, 10.0, 5.0
    Vf[2:, 1] = 1.0
    cfg = T.TwoTowerConfig(embed_dim=4, hidden=(), out_dim=4, epochs=0)
    m = T.init_params(3, 5, cfg, Uf, Vf, device="cpu")
    with torch.no_grad():
        m.user_embed.copy_(torch.from_numpy(Uf))
        m.item_embed.copy_(torch.from_numpy(Vf))
    ev_u, ev_i = np.array([0]), np.array([1])
    assert T.recall_at_k(m, ev_u, ev_i, k=1) == 0.0
    assert T.recall_at_k(m, ev_u, ev_i, k=1, exclude=(np.array([0]),
                                                      np.array([0])),
                         user_batch=2) == 1.0


def test_saves_load_across_packages(trained, tmp_path):
    t = trained["default"]
    jc, tc = t["cfgs"]
    # the reference's save -> the port
    J.save_two_tower(str(tmp_path / "ref"), t["ref"], jc, NU, NI)
    m, cfg, nu, ni = T.load_two_tower(str(tmp_path / "ref"), device="cpu")
    assert (nu, ni) == (NU, NI)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jc)
    for (path, g), (_, r) in zip(_flat(two_tower_to_arrays(m)),
                                 _flat(t["ref"]), strict=True):
        np.testing.assert_array_equal(g, r, err_msg=str(path))
    # the port's save -> the reference, and back through the class table
    T.save_two_tower(str(tmp_path / "port"), t["port"], tc, NU, NI)
    p2, cfg2, nu2, ni2 = J.load_two_tower(str(tmp_path / "port"))
    assert (nu2, ni2) == (NU, NI) and cfg2 == jc
    for (path, g), (_, r) in zip(_flat(_np(p2)),
                                 _flat(two_tower_to_arrays(t["port"])),
                                 strict=True):
        np.testing.assert_array_equal(g, r, err_msg=str(path))
    from tpu_als_torch.api import classes

    m2 = classes.load("tpu_als.models.two_tower", str(tmp_path / "port"),
                      device="cpu")
    assert isinstance(m2, T.TwoTower)
    assert T.recall_at_k(m2, *_interactions()[:2], k=5) == \
        T.recall_at_k(t["port"], *_interactions()[:2], k=5)
