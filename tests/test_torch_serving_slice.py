"""The serving slice as a whole: a model fitted and saved by ``tpu_als``,
served by ``tpu_als_torch`` on the CPU, must answer as the reference does.

Covered: loading the reference's save and carrying the arrays across with
``model_from_arrays``; ``FoldInServer.update`` (new and existing users)
then ``update_items`` (new and existing items), explicit and implicit;
``recommendForUserSubset``, ``recommendForAllUsers``, the item-side
``recommendFor*`` and ``recommend_arrays``, and ``transform`` with
unknown ids under both cold-start strategies; a port save loading in
``tpu_als``; ``IdMap``/``remap_ids``; the strict ratings CSV reader; and
``recommend`` on the command line of both packages, with and without an
item fold-in.

Tolerances: factors within 1e-3 of each row's norm (float32 solves whose
sums run in different orders, on rank-16 Grams of 5-7 ratings held up by
a ridge of only regParam·n, condition ~1e3); scores within 1e-4; ids by
the earns-its-score rule, since neither side promises a tie order.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_als
from tpu_als.io.movielens import load_movielens_csv, synthetic_movielens
from tpu_als.stream.microbatch import FoldInServer as JFoldInServer
import tpu_als_torch
from tpu_als_torch.io.ratings_csv import load_ratings_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL, ATOL = 1e-3, 1e-5
TOL = 1e-4


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    frame = synthetic_movielens(200, 80, 6000, seed=3)
    model = tpu_als.ALS(rank=16, maxIter=3, regParam=0.005, seed=0) \
        .fit(frame)
    path = str(tmp_path_factory.mktemp("slice") / "model")
    model.save(path)
    return path


def _both(path, implicit):
    jm = tpu_als.ALSModel.load(path)
    tm = tpu_als_torch.ALSModel.load(path, device="cpu")
    if implicit:
        for m in (jm, tm):
            m._params.update(implicitPrefs=True, alpha=40.0, regParam=0.01)
    return jm, tm


def _close_rows(t, j):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    scale = np.linalg.norm(j, axis=1, keepdims=True)
    assert np.all(np.abs(t - j) <= REL * scale + ATOL), \
        np.max(np.abs(t - j) / (scale + ATOL))


def _same_model(tm, jm):
    np.testing.assert_array_equal(tm._user_map.ids, jm._user_map.ids)
    np.testing.assert_array_equal(tm._item_map.ids, jm._item_map.ids)
    _close_rows(tm._U.numpy(), jm._U)
    _close_rows(tm._V.numpy(), jm._V)


def _foldin_batches(jm):
    rng = np.random.default_rng(5)
    users = np.concatenate([jm._user_map.ids[:6], [10_001, 10_002, 10_003]])
    u = np.repeat(users, 7)
    i = rng.choice(jm._item_map.ids, len(u))
    i[3] = 99_999  # an unknown item: dropped, it has no factors
    r = (rng.integers(1, 11, len(u)) * 0.5).astype(np.float32)
    user_batch = {"user": u, "item": i, "rating": r}
    items = np.concatenate([jm._item_map.ids[:4], [50_001, 50_002]])
    it = np.repeat(items, 5)
    item_batch = {"user": rng.choice(jm._user_map.ids, len(it)), "item": it,
                  "rating": (rng.integers(1, 11, len(it)) * 0.5)
                  .astype(np.float32)}
    return user_batch, item_batch


def _check_recs(tr, jr, tm, key, other_col):
    np.testing.assert_array_equal(tr[key], jr[key])
    ts, js = tr["recommendations"]["rating"], jr["recommendations"]["rating"]
    np.testing.assert_allclose(ts, js, rtol=TOL, atol=TOL)
    # earns-its-score: each id's own dot product on the port's factors
    ids = tr["recommendations"][other_col]
    Q = tm._U[torch.from_numpy(tm._user_map.to_dense(tr[key]))].numpy()
    V = tm._V.numpy()[tm._item_map.to_dense(ids)]
    np.testing.assert_allclose(np.einsum("nr,nkr->nk", Q, V), ts, rtol=TOL,
                               atol=TOL)
    assert (np.diff(ts, axis=1) <= 0).all()


def test_load_and_model_from_arrays_carry_the_same_weights(saved):
    jm = tpu_als.ALSModel.load(saved)
    tm = tpu_als_torch.ALSModel.load(saved, device="cpu")
    cm = tpu_als_torch.model_from_arrays(
        jm.rank, jm._user_map.ids, jm._U, jm._item_map.ids, jm._V,
        jm._params, device="cpu")
    for m in (tm, cm):
        assert m.device == torch.device("cpu") and m.rank == 16
        np.testing.assert_array_equal(m._U.numpy(), jm._U)
        np.testing.assert_array_equal(m._V.numpy(), jm._V)
        np.testing.assert_array_equal(m._user_map.ids, jm._user_map.ids)
        assert m._params == jm._params


@pytest.mark.parametrize("implicit", [False, True])
def test_foldin_server_matches_reference(saved, implicit):
    jm, tm = _both(saved, implicit)
    user_batch, item_batch = _foldin_batches(jm)
    js, ts = JFoldInServer(jm), tpu_als_torch.FoldInServer(tm)
    np.testing.assert_array_equal(ts.update(user_batch),
                                  js.update(user_batch))
    _same_model(tm, jm)
    np.testing.assert_array_equal(ts.update_items(item_batch),
                                  js.update_items(item_batch))
    _same_model(tm, jm)
    # history merge: the same users again fold in over all their ratings
    np.testing.assert_array_equal(ts.update(user_batch),
                                  js.update(user_batch))
    _same_model(tm, jm)
    assert len(ts.stats) == 3 and ts.latency(0.5) > 0

    users = {"user": user_batch["user"]}
    _check_recs(tm.recommendForUserSubset(users, 5),
                jm.recommendForUserSubset(users, 5), tm, "user", "item")
    _check_recs(tm.recommendForAllUsers(5), jm.recommendForAllUsers(5), tm,
                "user", "item")


def test_foldin_server_p50_latency_matches_reference(saved):
    """``p50_latency`` is ``latency(0.5)``, as the reference's."""
    jm, tm = _both(saved, implicit=False)
    user_batch, _ = _foldin_batches(jm)
    for srv in (JFoldInServer(jm), tpu_als_torch.FoldInServer(tm)):
        srv.update(user_batch)
        srv.update(user_batch)
        assert srv.p50_latency() == srv.latency(0.5) > 0


def test_foldin_server_prewarm_growth_matches_reference(saved):
    """``prewarm`` takes ``growth`` (both sides, the fixed table padded to
    further doublings) and leaves the model as it was; the fold-ins after
    it match the reference's."""
    jm, tm = _both(saved, implicit=True)
    user_batch, _ = _foldin_batches(jm)
    js, ts = JFoldInServer(jm), tpu_als_torch.FoldInServer(tm)
    kw = dict(rows=(4,), widths=(2,), sides=("user", "item"), growth=2)
    js.prewarm(**kw)
    ts.prewarm(**kw)
    _same_model(tm, jm)
    np.testing.assert_array_equal(ts.update(user_batch),
                                  js.update(user_batch))
    _same_model(tm, jm)


def test_item_side_recommend_matches_reference(saved):
    jm, tm = _both(saved, implicit=False)
    items = {"item": np.concatenate([jm._item_map.ids[5:12], [31337]])}
    for tr, jr in ((tm.recommendForItemSubset(items, 4),
                    jm.recommendForItemSubset(items, 4)),
                   (tm.recommendForAllItems(4), jm.recommendForAllItems(4))):
        np.testing.assert_array_equal(tr["item"], jr["item"])
        ts = tr["recommendations"]["rating"]
        np.testing.assert_allclose(ts, jr["recommendations"]["rating"],
                                   rtol=TOL, atol=TOL)
        Q = tm._V.numpy()[tm._item_map.to_dense(tr["item"])]
        U = tm._U.numpy()[tm._user_map.to_dense(
            tr["recommendations"]["user"])]
        np.testing.assert_allclose(np.einsum("nr,nkr->nk", Q, U), ts,
                                   rtol=TOL, atol=TOL)
    q, ids, sc = tm.recommend_arrays(4, for_users=False)
    jq, _, jsc = jm.recommend_arrays(4, for_users=False)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_allclose(sc, jsc, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("strategy", ["nan", "drop"])
def test_transform_matches_reference(saved, strategy):
    jm, tm = _both(saved, implicit=False)
    jm.setColdStartStrategy(strategy)
    tm.setColdStartStrategy(strategy)
    rng = np.random.default_rng(6)
    pairs = {"user": np.concatenate([rng.choice(jm._user_map.ids, 40),
                                     [-5, 424242]]),
             "item": np.concatenate([rng.choice(jm._item_map.ids, 40),
                                     [jm._item_map.ids[0], 777]])}
    pairs["item"][3] = 31337  # unknown item for a known user
    jt, tt = jm.transform(pairs), tm.transform(pairs)
    assert tt.columns == jt.columns
    np.testing.assert_array_equal(tt["user"], jt["user"])
    np.testing.assert_allclose(tt["prediction"], jt["prediction"],
                               rtol=TOL, atol=TOL)  # NaN positions equal
    assert np.isnan(tt["prediction"]).sum() == (3 if strategy == "nan"
                                                else 0)
    assert np.isnan(tm.predict(-5, jm._item_map.ids[0]))


def test_port_save_loads_in_reference(saved, tmp_path):
    _, tm = _both(saved, implicit=False)
    tpu_als_torch.FoldInServer(tm).update(
        {"user": np.array([9_000, 9_000]),
         "item": tm._item_map.ids[:2], "rating": np.array([4.0, 5.0])})
    out = str(tmp_path / "port_model")
    tm.save(out)
    with pytest.raises(IOError):
        tm.save(out)
    tm.write().overwrite().save(out)
    jm = tpu_als.ALSModel.load(out)
    np.testing.assert_array_equal(jm._U, tm._U.numpy())
    np.testing.assert_array_equal(jm._V, tm._V.numpy())
    np.testing.assert_array_equal(jm._user_map.ids, tm._user_map.ids)
    assert jm._params == tm._params


@pytest.mark.parametrize("with_items", [False, True])
def test_recommend_cli_prints_the_reference_lines(saved, tmp_path, capsys,
                                                  with_items):
    from tpu_als.cli import main as jmain

    jm = tpu_als.ALSModel.load(saved)
    csv = tmp_path / "new.csv"
    rng = np.random.default_rng(8)
    lines = ["userId,movieId,rating,timestamp"]
    for u in (int(jm._user_map.ids[0]), 10_001, 10_002):
        # 30 ratings per user keep the rank-16 Gram well conditioned
        for it in rng.choice(jm._item_map.ids, 30, replace=False):
            lines.append(f"{u},{int(it)},{rng.integers(1, 11) * 0.5},1")
    csv.write_text("\n".join(lines) + "\n")
    argv = ["recommend", "--model", saved, "--foldin-data", f"csv:{csv}",
            "--users", f"{int(jm._user_map.ids[0])},10001,10002,424242",
            "--k", "5"]
    if with_items:
        # an existing and a new item, each rated by 30 known users
        items_csv = tmp_path / "new_items.csv"
        lines = ["userId,movieId,rating,timestamp"]
        for it in (int(jm._item_map.ids[1]), 60_001):
            for u in rng.choice(jm._user_map.ids, 30, replace=False):
                lines.append(f"{int(u)},{it},{rng.integers(1, 11) * 0.5},1")
        items_csv.write_text("\n".join(lines) + "\n")
        argv += ["--foldin-items-data", f"csv:{items_csv}"]
    jmain(argv)
    want = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    got = subprocess.run(
        [sys.executable, "-m", "tpu_als_torch.cli", *argv, "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr
    assert "folded in 90 ratings touching 3 users" in got.stderr
    got = [json.loads(x) for x in got.stdout.splitlines()]
    assert [g["user"] for g in got] == [w["user"] for w in want] \
        == [int(jm._user_map.ids[0]), 10_001, 10_002]
    for g, w in zip(got, want):
        gs = np.array([s for _, s in g["items"]])
        ws = np.array([s for _, s in w["items"]])
        # one unit of the 4th decimal: rounding may split a 1e-7 difference
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1.01e-4)
        # ids agree wherever the score is not tied with a neighbour
        untied = np.ones(len(ws), bool)
        close = np.abs(np.diff(ws)) <= 1e-4
        untied[:-1] &= ~close
        untied[1:] &= ~close
        assert [i for (i, _), u in zip(g["items"], untied) if u] == \
            [i for (i, _), u in zip(w["items"], untied) if u]


def test_remap_ids_and_id_map_match_reference():
    from tpu_als.core.ratings import remap_ids as jremap
    from tpu_als_torch.core.ratings import IdMap, remap_ids

    raw = np.random.default_rng(9).choice([7, -3, 2 ** 40, 12, 5], 50)
    (td, tmap), (jd, jmap) = remap_ids(raw), jremap(raw)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tmap.ids, jmap.ids)
    probe = np.array([12, 99, -3, 2 ** 40, 6])
    np.testing.assert_array_equal(tmap.to_dense(probe), jmap.to_dense(probe))
    np.testing.assert_array_equal(IdMap(ids=np.array([], np.int64))
                                  .to_dense(probe), -1)


@pytest.mark.parametrize("raw", [
    np.array([127, -128, 0, -128, 5, 127, -1], np.int8),
    np.array([255, 0, 7, 255, 0], np.uint8),
    np.array([2 ** 64 - 1, 2 ** 64 - 5, 2 ** 64 - 1, 2 ** 64 - 3,
              2 ** 64 - 40], np.uint64),
    np.array([-10 ** 12 + 7, -10 ** 12, -10 ** 12 + 3, -10 ** 12 + 7,
              -10 ** 12 + 1000], np.int64),
    np.full(6, 42, np.int64),
    np.array([-(2 ** 15), 2 ** 15 - 1, 0], np.int16),
], ids=["int8_extremes", "uint8_extremes", "uint64_top", "neg_int64",
        "one_value", "int16_extremes"])
def test_remap_ids_occupancy_table_matches_reference(raw, monkeypatch):
    """Bounded integer ids take the occupancy table (np.unique is barred
    during the port's call) and give the reference's arrays exactly,
    dtypes included."""
    from tpu_als.core.ratings import remap_ids as jremap
    from tpu_als_torch.core.ratings import remap_ids

    raw = np.random.default_rng(3).permutation(np.tile(raw, 3))
    jd, jmap = jremap(raw)

    def barred(*a, **kw):
        raise AssertionError("np.unique called: not the occupancy table")

    with monkeypatch.context() as m:
        m.setattr(np, "unique", barred)
        td, tmap = remap_ids(raw)
    np.testing.assert_array_equal(td, jd)
    assert td.dtype == np.int64
    np.testing.assert_array_equal(tmap.ids, jmap.ids)
    assert tmap.ids.dtype == jmap.ids.dtype == raw.dtype
    np.testing.assert_array_equal(tmap.to_dense(raw), jmap.to_dense(raw))


def test_ratings_csv_matches_reference_reader(tmp_path):
    p = tmp_path / "ratings.csv"
    p.write_text("userId,movieId,rating,timestamp\n1,2,3.5,100\r\n\n"
                 "-7,9223372036854775807,5e-1,0  \n40,50,1,7\n")
    t, j = load_ratings_csv(str(p)), load_movielens_csv(str(p))
    for col in ("user", "item", "rating", "timestamp"):
        np.testing.assert_array_equal(t[col], j[col])
        assert t[col].dtype == j[col].dtype


@pytest.mark.parametrize("bad", ['1,2,"3.0",4', "1,2,3", "1,2,nan,4",
                                 "1,2,3,4,5", "1,2,3.0x,4",
                                 "1,9223372036854775808,3,4"])
def test_ratings_csv_rejects_malformed_lines(tmp_path, bad):
    p = tmp_path / "bad.csv"
    p.write_text(f"userId,movieId,rating,timestamp\n1,2,3,4\n{bad}\n")
    with pytest.raises(ValueError, match="malformed ratings line"):
        load_ratings_csv(str(p))
    with pytest.raises(ValueError, match="malformed ratings line"):
        load_movielens_csv(str(p))


def test_user_and_item_factors_match_reference(saved):
    """``userFactors`` / ``itemFactors``: the reference's frames, the same
    ids in the same order, each row's features equal in float32."""
    jm, tm = _both(saved, implicit=False)
    for name in ("userFactors", "itemFactors"):
        tf, jf = getattr(tm, name), getattr(jm, name)
        assert tf.columns == jf.columns == ["id", "features"]
        np.testing.assert_array_equal(tf["id"], jf["id"])
        assert tf["id"].dtype == jf["id"].dtype
        got, ref = np.stack(tf["features"]), np.stack(jf["features"])
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_recommend_zero_items_gives_the_references_empty_results(saved):
    """k = 0: ``recommend_arrays`` and every ``recommendFor*`` return the
    reference's empty [n, 0] results (shapes and dtypes), on one device
    and over a mesh, and launch nothing."""
    from tpu_als_torch.ops import cuda_topk
    from tpu_als_torch.parallel.mesh import make_mesh

    jm, tm = _both(saved, implicit=False)
    before = (cuda_topk.LAUNCHES, cuda_topk.MERGE_LAUNCHES,
              cuda_topk.SCAN_CALLS)
    for kw in ({}, {"for_users": False}):
        got, ref = tm.recommend_arrays(0, **kw), jm.recommend_arrays(0, **kw)
        np.testing.assert_array_equal(got[0], ref[0])
        for g, j in zip(got[1:], ref[1:]):
            assert g.shape == j.shape == (len(ref[0]), 0)
            assert g.dtype == j.dtype
    for strategy in ("merge_ring", "ring", "all_gather"):
        _, ids, sc = tm.recommend_arrays(0, mesh=make_mesh(
            devices=["cpu"] * 2), gatherStrategy=strategy)
        assert ids.shape == sc.shape == (len(tm._user_map), 0)
    users = {"user": jm._user_map.ids[:5]}
    items = {"item": jm._item_map.ids[:3]}
    for key, tr, jr in (
            ("user", tm.recommendForAllUsers(0), jm.recommendForAllUsers(0)),
            ("item", tm.recommendForAllItems(0), jm.recommendForAllItems(0)),
            ("user", tm.recommendForUserSubset(users, 0),
             jm.recommendForUserSubset(users, 0)),
            ("item", tm.recommendForItemSubset(items, 0),
             jm.recommendForItemSubset(items, 0))):
        np.testing.assert_array_equal(tr[key], jr[key])
        g, j = tr["recommendations"], jr["recommendations"]
        assert g.shape == j.shape and g.shape[1] == 0
        assert g.dtype == j.dtype
    assert (cuda_topk.LAUNCHES, cuda_topk.MERGE_LAUNCHES,
            cuda_topk.SCAN_CALLS) == before
