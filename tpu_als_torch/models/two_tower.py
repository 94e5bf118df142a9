"""Two-tower neural retrieval warm-started from ALS factors.

Counterpart of ``tpu_als/models/two_tower.py`` (BASELINE.json config 5):
user and item embedding tables initialized from fitted ALS factors, a
small MLP tower per side, trained with the in-batch sampled softmax
under Adam (``torch.optim.Adam``; the reference uses ``optax.adam``, whose
defaults are the same).  The gradient comes from autograd; the towers are
small dense layers, so no kernel of the port is written for them.

Scoring shares the serving path with ALS: tower outputs are plain
``[N, d]`` matrices, and unfiltered recall retrieves through
:func:`tpu_als_torch.ops.cuda_topk.topk_scores` (K5 on the card, its
plain chunked version on the CPU).  The filtered protocol's
``[user_batch, num_items]`` product is a plain ``torch.matmul`` (the
reference computes it with XLA, outside any Pallas kernel) followed by
the stable top-k (:func:`tpu_als_torch.ops.topk.stable_topk`, the tie
order of ``lax.top_k``).

The model is a :class:`TwoTower` module.  The functions keep the
reference's names and arguments with the module in place of its params
pytree; :func:`save_two_tower` writes the reference's format (leaves in
``jax.tree_util.tree_flatten`` order, weights ``(din, dout)``), so a save
of either package loads in the other.  ``torch`` cannot draw
``jax.random``'s bits: :func:`init_params` draws from a
``torch.Generator`` seeded by ``cfg.seed``, and a caller who needs the
reference's start passes ``train_two_tower(init=...)``
(:func:`tpu_als_torch.convert.two_tower_from_arrays`).
"""

from __future__ import annotations

import copy
import json
import os
import shutil
from dataclasses import asdict, dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_als_torch.ops.cuda_topk import topk_scores
from tpu_als_torch.ops.topk import NEG_INF, stable_topk
from tpu_als_torch.utils.platform import resolve_device


@dataclass(frozen=True)
class TwoTowerConfig:
    embed_dim: int = 32
    hidden: tuple = (64,)
    out_dim: int = 32
    learning_rate: float = 1e-3
    batch_size: int = 4096
    epochs: int = 5
    temperature: float = 0.1
    seed: int = 0
    # logQ sampled-softmax correction: in-batch negatives are sampled in
    # proportion to item popularity; subtracting log q(item) from each
    # candidate logit removes that bias
    popularity_correction: bool = True
    # learning-rate multiplier for the embedding TABLES only (towers
    # always train at learning_rate): 0.0 freezes warm-started tables,
    # values in (0, 1) slow their drift, 1.0 is one optimizer for all
    embed_lr_scale: float = 1.0


def _dims(cfg):
    return (cfg.embed_dim,) + tuple(cfg.hidden) + (cfg.out_dim,)


class Tower(nn.Module):
    """One side's MLP: ``nn.Linear`` layers with ReLU between them, the
    input added back when the output width equals the input's, the
    output divided by ``max(‖h‖, 1e-6)`` (the reference's ``_tower``)."""

    def __init__(self, dims):
        super().__init__()
        # skip_init: the values are set by init_params or a load, and
        # nn.Linear's own init would draw from torch's global generator
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, din, dout)
            for din, dout in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        h = x
        for li, layer in enumerate(self.layers):
            h = layer(h)
            if li + 1 < len(self.layers):
                h = F.relu(h)
        if h.shape[-1] == x.shape[-1]:
            h = h + x   # residual: the identity at init (last layer zero)
        return h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True),
                               min=1e-6)


class TwoTower(nn.Module):
    """Embedding tables (``user_embed`` [num_users, embed_dim],
    ``item_embed`` [num_items, embed_dim], dense parameters) and the two
    towers; ``cfg`` is the :class:`TwoTowerConfig` it was built for."""

    def __init__(self, num_users, num_items, cfg):
        super().__init__()
        self.cfg = cfg
        self.user_embed = nn.Parameter(torch.zeros(num_users, cfg.embed_dim))
        self.item_embed = nn.Parameter(torch.zeros(num_items, cfg.embed_dim))
        self.user_tower = Tower(_dims(cfg))
        self.item_tower = Tower(_dims(cfg))

    def leaves(self):
        """The parameters in the reference's ``tree_flatten`` order
        (sorted keys; ``b`` before ``w`` in a layer), each with the
        reference's layout: a weight ``(din, dout)``, the transpose of
        ``nn.Linear``'s."""
        out = []
        for name in ("item_embed", "item_tower", "user_embed",
                     "user_tower"):
            part = getattr(self, name)
            if isinstance(part, Tower):
                for layer in part.layers:
                    out += [layer.bias, layer.weight.T]
            else:
                out.append(part)
        return out

    def set_leaves(self, arrays):
        """Copy ``arrays`` (numpy, in :meth:`leaves`' order and layout)
        into the parameters; ValueError on a count or shape mismatch."""
        mine = self.leaves()
        if len(arrays) != len(mine):
            raise ValueError(
                f"got {len(arrays)} leaves; this model's structure has "
                f"{len(mine)} — config/version mismatch")
        with torch.no_grad():
            for k, (dst, src) in enumerate(zip(mine, arrays)):
                src = np.array(src, dtype=np.float32)
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"leaf {k}: saved shape {src.shape} != expected "
                        f"{tuple(dst.shape)} (num_users/num_items/config "
                        "mismatch)")
                dst.copy_(torch.from_numpy(src))
        return self

    @classmethod
    def load(cls, path, device=None):
        return load_two_tower(path, device=device)[0]


def init_params(num_users, num_items, cfg: TwoTowerConfig,
                als_user_factors=None, als_item_factors=None,
                device=None):
    """A :class:`TwoTower` on ``device`` (None -> the CUDA device):
    tables drawn N(0, 0.05²), their first ``min(r, embed_dim)`` columns
    the ALS warm start when factors are given; He-normal layer weights,
    the last layer of each tower zero, biases zero.  Draws come from a
    ``torch.Generator`` seeded by ``cfg.seed``: user table, item table,
    user tower, item tower."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(cfg.seed))
    m = TwoTower(num_users, num_items, cfg)
    with torch.no_grad():
        for table, warm in ((m.user_embed, als_user_factors),
                            (m.item_embed, als_item_factors)):
            table.copy_(0.05 * torch.randn(table.shape, generator=g))
            if warm is not None:
                warm = torch.as_tensor(np.asarray(warm, dtype=np.float32))
                r = min(warm.shape[1], cfg.embed_dim)
                table[:, :r] = warm[:, :r]
        for tower in (m.user_tower, m.item_tower):
            for li, layer in enumerate(tower.layers):
                dout, din = layer.weight.shape
                w = torch.randn((dout, din), generator=g) * (2.0 / din) ** 0.5
                if li == len(tower.layers) - 1:
                    # with the residual, the towers start as the identity:
                    # an ALS warm start is exact at epoch 0
                    w = torch.zeros_like(w)
                layer.weight.copy_(w)
                layer.bias.zero_()
    return m.to(device)


def user_repr(params, u_idx):
    return params.user_tower(params.user_embed[u_idx])


def item_repr(params, i_idx):
    return params.item_tower(params.item_embed[i_idx])


def in_batch_softmax_loss(params, u_idx, i_idx, weights, temperature,
                          log_q=None):
    """Sampled softmax with in-batch negatives: every other item of the
    batch is a negative for each (user, item) positive.  ``log_q``
    [num_items], when given, is subtracted from each candidate's logit
    (the logQ correction).  The weighted mean ``Σ w·loss / max(Σ w,
    1e-6)``."""
    zu = user_repr(params, u_idx)
    zi = item_repr(params, i_idx)
    logits = (zu @ zi.T) / temperature
    if log_q is not None:
        logits = logits - log_q[i_idx][None, :]
    labels = torch.arange(zu.shape[0], device=logits.device)
    losses = F.cross_entropy(logits, labels, reduction="none")
    return torch.sum(losses * weights) / torch.clamp(torch.sum(weights),
                                                     min=1e-6)


def _optimizer(params, cfg):
    """The reference's optax transform in torch: one Adam when
    ``embed_lr_scale == 1``; else the towers' Adam at ``learning_rate``
    and, for the tables, nothing at all (scale 0: ``set_to_zero``, the
    tables stay bitwise the warm start) or a second Adam at
    ``learning_rate·scale``."""
    lr = cfg.learning_rate
    if cfg.embed_lr_scale == 1.0:
        return torch.optim.Adam(params.parameters(), lr=lr)
    towers = (list(params.user_tower.parameters())
              + list(params.item_tower.parameters()))
    groups = [{"params": towers, "lr": lr}]
    if cfg.embed_lr_scale != 0.0:
        groups.append({"params": [params.user_embed, params.item_embed],
                       "lr": lr * cfg.embed_lr_scale})
    return torch.optim.Adam(groups, lr=lr)


def train_two_tower(u_idx, i_idx, num_users, num_items,
                    cfg: TwoTowerConfig = TwoTowerConfig(),
                    als_user_factors=None, als_item_factors=None,
                    weights=None, callback=None, init=None, device=None):
    """Train on positive (user, item) interactions; returns the
    :class:`TwoTower` on ``device`` (None -> the CUDA device).

    ``init``: a :class:`TwoTower` to start from (copied, not changed),
    in place of :func:`init_params`' draw (the warm-start factors are
    then ignored).  Each epoch draws a permutation from
    ``default_rng(cfg.seed)`` and takes ``n // batch_size`` steps, as
    the reference does; ``callback(epoch, mean_loss, params)`` runs after
    each epoch.  Each step reads its loss back to the host (the
    reference's ``float(loss)``), so the epoch mean is the reference's.
    """
    device = resolve_device(device)
    u_idx = np.asarray(u_idx)
    i_idx = np.asarray(i_idx)
    n = len(u_idx)
    weights = (np.ones(n, dtype=np.float32) if weights is None
               else np.asarray(weights, dtype=np.float32))
    if init is None:
        params = init_params(num_users, num_items, cfg, als_user_factors,
                             als_item_factors, device=device)
    else:
        params = copy.deepcopy(init).to(device)
    opt = _optimizer(params, cfg)
    log_q = None
    if cfg.popularity_correction:
        log_q = torch.tensor(
            log_popularity(np.bincount(i_idx, minlength=num_items)),
            dtype=torch.float32, device=device)
    u_dev = torch.as_tensor(u_idx, dtype=torch.int64, device=device)
    i_dev = torch.as_tensor(i_idx, dtype=torch.int64, device=device)
    w_dev = torch.as_tensor(weights, device=device)

    bs = min(cfg.batch_size, n)
    steps_per_epoch = max(1, n // bs)
    rng = np.random.default_rng(cfg.seed)
    for epoch in range(cfg.epochs):
        perm = rng.permutation(n)
        losses = []
        for s in range(steps_per_epoch):
            sel = perm[s * bs:(s + 1) * bs]
            if len(sel) < bs:  # the reference keeps its shapes static
                sel = np.concatenate([sel, perm[:bs - len(sel)]])
            sel = torch.from_numpy(sel).to(device)
            opt.zero_grad(set_to_none=True)
            loss = in_batch_softmax_loss(params, u_dev[sel], i_dev[sel],
                                         w_dev[sel], cfg.temperature, log_q)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        if callback is not None:
            callback(epoch + 1, float(np.mean(losses)), params)
    return params


def ban_lists(users, train_u, train_i, user_batch):
    """Partition each eval user's train items into user batches — the
    filtered protocol's exclusion machinery.

    ``users`` must be sorted (np.unique output).  Returns ``(tpos, tit,
    bounds)``: train positions into ``users`` (stable-sorted), their item
    ids, and ``bounds[bi]:bounds[bi+1]`` slicing batch ``bi``'s bans
    (rows re-base as ``tpos - bi*user_batch``).
    """
    tu = np.asarray(train_u)
    ti = np.asarray(train_i)
    keep = np.isin(tu, users)
    tpos = np.searchsorted(users, tu[keep])
    tit = np.asarray(ti[keep])
    order = np.argsort(tpos, kind="stable")
    tpos, tit = tpos[order], tit[order]
    bounds = np.searchsorted(
        tpos, np.arange(0, len(users) + user_batch, user_batch))
    return tpos, tit, bounds


def log_popularity(item_counts):
    """Add-1-smoothed log empirical item popularity, ``log q(item)``:
    the training logQ correction and the serving prior share it."""
    counts = np.asarray(item_counts, dtype=np.float64)
    q = (counts + 1.0) / (counts.sum() + len(counts))
    return np.log(q)


def serving_bias(item_counts, temperature):
    """Popularity prior for serving, ``temperature · log q(item)``: adds
    back at serving what the logQ-corrected training removed, pre-scaled
    for ``recall_at_k(..., item_bias=...)`` on raw cosines."""
    return (temperature * log_popularity(item_counts)).astype(np.float32)


def _banned_topk(zu_b, zi, ban_rows, ban_cols, bias, k):
    """Top-k item ids over all items with the (row, col) score entries
    banned; ``bias`` [num_items] is added to every user's scores.  The
    reference pads its ban lists with rows past the batch and drops them
    in the scatter; the port receives only the real bans."""
    scores = zu_b @ zi.T + bias[None, :]
    scores[ban_rows, ban_cols] = NEG_INF
    return stable_topk(scores, k)[1]


@torch.no_grad()
def recall_at_k(params, eval_u, eval_i, k=10, item_chunk=8192,
                exclude=None, user_batch=2048, item_bias=None):
    """Fraction of held-out (user, item) pairs whose item appears in the
    user's top-k retrieval — the config-5 metric.

    ``exclude``: optional ``(train_u, train_i)``; each user's training
    items are removed from their candidates first (the filtered
    protocol).  ``item_bias`` [num_items]: an additive per-item score
    bias (:func:`serving_bias`).  With neither, retrieval goes through
    :func:`~tpu_als_torch.ops.cuda_topk.topk_scores` (K5 on the card).
    """
    eval_u = np.asarray(eval_u)
    eval_i = np.asarray(eval_i)
    dev = params.item_embed.device
    num_items = params.item_embed.shape[0]
    users, inv = np.unique(eval_u, return_inverse=True)
    zi = item_repr(params, torch.arange(num_items, device=dev))

    if exclude is None and item_bias is None:
        zu = user_repr(params, torch.as_tensor(users, device=dev))
        _, topk = topk_scores(
            zu, zi, torch.ones(num_items, dtype=torch.bool, device=dev),
            k, item_chunk=item_chunk)
        topk = topk.cpu().numpy()
        hits = (topk[inv] == eval_i[:, None]).any(axis=1)
        return float(hits.mean())
    if exclude is None:
        exclude = (np.empty(0, np.int64), np.empty(0, np.int64))

    # bound the [user_batch, num_items] score tensor to ~256 MB f32 (an
    # explicitly small user_batch is honored)
    user_batch = min(user_batch, max(64, (1 << 26) // max(num_items, 1)))
    bias = (torch.zeros(num_items, dtype=torch.float32, device=dev)
            if item_bias is None
            else torch.as_tensor(np.asarray(item_bias, dtype=np.float32),
                                 device=dev))
    nb = len(users)
    topk = np.zeros((nb, k), dtype=np.int32)
    tpos_s, tit_s, bounds = ban_lists(users, exclude[0], exclude[1],
                                      user_batch)
    for bi, s in enumerate(range(0, nb, user_batch)):
        e = min(s + user_batch, nb)
        ub = users[s:e]
        if len(ub) < user_batch:  # the reference's padding, user 0
            ub = np.pad(ub, (0, user_batch - len(ub)))
        lo, hi = bounds[bi], bounds[bi + 1]
        rows = torch.as_tensor(tpos_s[lo:hi] - s, device=dev)
        cols = torch.as_tensor(tit_s[lo:hi], device=dev)
        zu_b = user_repr(params, torch.as_tensor(ub, device=dev))
        topk[s:e] = _banned_topk(zu_b, zi, rows, cols, bias,
                                 k)[: e - s].cpu().numpy()
    hits = (topk[inv] == eval_i[:, None]).any(axis=1)
    return float(hits.mean())


def save_two_tower(path, params, cfg: TwoTowerConfig, num_users,
                   num_items):
    """Persist a trained tower model in the reference's format: config
    and entity counts as JSON, the leaves (:meth:`TwoTower.leaves`) as
    one npz, installed atomically (the reference's class name, so either
    package loads it)."""
    from tpu_als_torch.api.classes import saved_name
    from tpu_als_torch.io.checkpoint import atomic_install

    leaves = [x.detach().cpu().numpy() for x in params.leaves()]
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "params.npz"),
             **{f"leaf_{k}": v for k, v in enumerate(leaves)})
    with open(os.path.join(tmp, "two_tower.json"), "w") as f:
        json.dump({"class": saved_name(params),
                   "config": asdict(cfg),
                   "num_users": int(num_users),
                   "num_items": int(num_items),
                   "n_leaves": len(leaves)}, f, indent=2)
    atomic_install(tmp, path)


def load_two_tower(path, device=None):
    """Restore ``(params, cfg, num_users, num_items)`` saved by either
    package's ``save_two_tower``; ``params`` lands on ``device`` (None
    -> the CUDA device).  Leaf count and shapes are verified against the
    structure the saved config builds."""
    with open(os.path.join(path, "two_tower.json")) as f:
        meta = json.load(f)
    if meta.get("class") != "tpu_als.models.two_tower":
        raise ValueError(f"{path} holds a {meta.get('class')!r} save, "
                         "not a two-tower model")
    c = dict(meta["config"])
    c["hidden"] = tuple(c["hidden"])
    cfg = TwoTowerConfig(**c)
    num_users, num_items = meta["num_users"], meta["num_items"]
    device = resolve_device(device)
    m = TwoTower(num_users, num_items, cfg)
    if meta["n_leaves"] != len(m.leaves()):
        raise ValueError(
            f"saved model has {meta['n_leaves']} leaves; this build's "
            f"structure has {len(m.leaves())} — config/version mismatch")
    with np.load(os.path.join(path, "params.npz"),
                 allow_pickle=False) as dat:
        m.set_leaves([dat[f"leaf_{k}"] for k in range(meta["n_leaves"])])
    return m.to(device), cfg, num_users, num_items
