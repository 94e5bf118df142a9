"""The port's execution planner (``tpu_als_torch.plan``) against the
reference's (``tpu_als.plan``), on the CPU.

- The cache: equal keys digest equal in both packages; an entry either
  package writes validates under the other's ``_validate``; a corrupt and
  a schema-mismatched file are typed, quarantined with their ``.reason``
  and read as a miss; ``list_entries`` and ``clear`` read a directory as
  the reference's do.
- The resolvers: ``shape_class``, ``gather_model`` and
  ``resolve_gather_strategy`` equal the reference's on a grid of shapes;
  an observed serving ladder is banked and the bare default then reads
  it back in the reference's sequence; a banked live cadence is read
  back; two same-shaped tenants share one entry file.
- Equivalence: on a tiny fit, planner off, armed cold and armed warm give
  the same route labels and bitwise the same factors, with the cold and
  warm trails the reference's discipline gives.
- Off is free: a non-default kernel config banked with
  ``TPU_ALS_AUTOTUNE`` unset changes nothing, bitwise; with it set, the
  banked split width moves the wider buckets from K4 to K3 (+ K1), and
  the factors stay within rtol 1e-4 / atol 1e-5 of the untuned fit (the
  same sums in another order).
- ``plan show|warm|clear`` print the reference's keys.

Everything else here is exact (equal values, bitwise factors); no
test asserts a time.
"""

import json
import os

import numpy as np
import pytest
import torch

from tpu_als import obs as jobs
from tpu_als import plan as jplan
from tpu_als.plan import cache as jcache
from tpu_als_torch import obs as tobs
from tpu_als_torch import plan as tplan
from tpu_als_torch.core import als as tals
from tpu_als_torch.core.ratings import build_csr_buckets
from tpu_als_torch.ops import cuda_gather_ne
from tpu_als_torch.plan import cache as tcache

ENV = "TPU_ALS_PLAN_CACHE"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny tensors: under the suite's
    workers a thread pool per small op mostly waits for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """Each test its own cache directory (shared by both packages: their
    keys never collide), the autotune gate off, fresh obs registries."""
    monkeypatch.setenv(ENV, str(tmp_path / "plan"))
    monkeypatch.delenv(tplan.AUTOTUNE_ENV, raising=False)
    jobs.reset(), tobs.reset()
    yield
    jobs.reset(), tobs.reset()


def _evs(o, etype):
    """``etype`` events of either package's registry."""
    return [e for e in o.default_registry()._events if e["type"] == etype]


def _types(o, prefix=("plan_", "tune_")):
    return [e["type"] for e in o.default_registry()._events
            if e["type"].startswith(prefix)]


def _entry(key, resolved="kernel"):
    return {"schema_version": 1, "plan_key": key, "probes": {},
            "components": {"topk:k=5": {
                "resolved": resolved,
                "provenance": {"banked_at": "2026-10-18T00:00:00+00:00"}}}}


# -- the cache --------------------------------------------------------------

@pytest.mark.parametrize("key", [
    {"rank": 4, "dtype": "float32"},
    {"device_kind": "cuda:NVIDIA H100 80GB HBM3", "torch_version": "2.5",
     "rank": 128, "dtype": "bfloat16", "shape_class": "generic",
     "mesh_shape": [4], "device_count": 4},
    {"rank": 8, "dtype": "float32", "mesh_shape": None}])
def test_key_digest_equal_for_equal_dicts(key):
    assert tcache.key_digest(key) == tcache.key_digest(dict(key)) == \
        jcache.key_digest(key)
    assert tcache.key_digest(key) != tcache.key_digest(
        dict(key, rank=key["rank"] + 1))
    assert tcache.SCHEMA_VERSION == jcache.SCHEMA_VERSION
    assert tcache.ENV_VAR == jcache.ENV_VAR


def test_port_keys_name_the_device_and_torch():
    cpu = tplan.plan_key(rank=8, dtype="float32", device="cpu")
    assert cpu["device_kind"].startswith("cpu:")
    assert cpu["torch_version"] == tcache._torch_version() != "unknown"
    assert "jax_version" not in cpu
    assert set(cpu) == set(jplan.plan_key(rank=8, dtype="float32")) \
        - {"jax_version"} | {"torch_version"}


def test_entries_validate_under_both_packages():
    """The port's entries (every component kind it banks) pass the
    reference's _validate, and the reference's pass the port's."""
    tplan.resolve_topk(rank=8, k=5, walk=lambda: "kernel", device="cpu")
    tals.plan_training(tals.AlsConfig(rank=8), 8, device="cpu")
    tplan.resolve_serving_buckets(rank=8, observed=[3, 5, 9])
    tplan.resolve_live_cadence(rank=8)
    tplan.resolve_gather_strategy(n_users=100, n_items=50, rank=8,
                                  n_devices=4)
    tplan.resolve_kernel_config(rank=8, tune=True, device="cpu",
                                timer=lambda c: 1.0, space={})
    jplan.resolve_topk(rank=8, k=5, walk=lambda: "xla")
    jplan.resolve_serving_buckets(rank=8, observed=[3, 5, 9])
    entries = tcache.list_entries()
    mine = [d for _, d in entries if "torch_version" in d["plan_key"]]
    theirs = [d for _, d in entries if "jax_version" in d["plan_key"]]
    # the port: one entry for rank 8 and one for the gather's shape class
    assert len(mine) == 2 and len(theirs) == 1
    assert {c for d in mine for c in d["components"]} >= {
        "topk:k=5", "serving_buckets", "live_cadence", "gather:D=4",
        "kernel_config"}
    for path, doc in entries:
        assert jcache._validate(doc, path) is doc
        assert tcache._validate(doc, path) is doc
    # and each package loads the other's file by its key
    for doc in mine + theirs:
        for mod in (tcache, jcache):
            assert mod.load_entry(doc["plan_key"]) == doc


def _corrupt(path, kind):
    if kind == "unparseable":
        with open(path, "w", encoding="utf-8") as f:
            f.write("{ this is not json")
    else:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        doc["schema_version"] = 999
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)


@pytest.mark.parametrize("kind,match", [("unparseable", "unreadable JSON"),
                                        ("schema", "schema_version")])
def test_corrupt_entry_is_typed_quarantined_and_a_miss(kind, match):
    walk = lambda: "kernel"  # noqa: E731
    tplan.resolve_topk(rank=8, k=5, walk=walk, device="cpu")
    key = tplan.plan_key(rank=8, dtype="float32", device="cpu")
    path = tcache.entry_path(key)
    _corrupt(path, kind)
    for mod in (tcache, jcache):
        with pytest.raises(mod.PlanCacheCorrupt, match=match) as ei:
            mod.load_entry(key)
        assert ei.value.path == path
    tobs.reset()
    assert tplan.resolve_topk(rank=8, k=5, walk=walk, device="cpu") == \
        "kernel"
    miss = _evs(tobs, "plan_cache_miss")
    assert [m["reason"] for m in miss] == ["corrupt"]
    assert any("quarantined" in e["reason"]
               for e in _evs(tobs, "warning"))
    qdir = os.path.join(os.path.dirname(path), ".corrupt")
    reasons = [n for n in os.listdir(qdir) if n.endswith(".reason")]
    assert len(reasons) == 1
    with open(os.path.join(qdir, reasons[0]), encoding="utf-8") as f:
        assert match.split()[0] in f.read()
    # re-banked valid
    assert tcache.load_entry(key)["components"]["topk:k=5"]["resolved"] == \
        "kernel"


def test_list_entries_and_clear_as_the_reference(tmp_path):
    """Both packages read the same directory contents alike: valid
    entries, a garbage file and a schema mismatch flagged, other files
    ignored, and ``clear`` drops the entry files only."""
    root = str(tmp_path / "plan")
    for rank in (4, 8):
        key = {"rank": rank, "dtype": "float32"}
        tcache.store_entry(key, _entry(key))
    with open(os.path.join(root, "plan_deadbeef00.json"), "w") as f:
        f.write("garbage")
    with open(os.path.join(root, "plan_schema0000.json"), "w") as f:
        json.dump(dict(_entry({"rank": 1}), schema_version=7), f)
    with open(os.path.join(root, "notes.txt"), "w") as f:
        f.write("not an entry")

    def seen(mod):
        return [(os.path.basename(p), type(d).__name__,
                 d if isinstance(d, dict) else d.reason)
                for p, d in mod.list_entries()]

    assert seen(tcache) == seen(jcache)
    assert [k for _, k, _ in seen(tcache)].count("PlanCacheCorrupt") == 2
    assert tcache.clear() == 4
    assert tcache.list_entries() == jcache.list_entries() == []
    assert os.listdir(root) == ["notes.txt"]
    assert tcache.clear(root) == jcache.clear(root) == 0


def test_probe_budget_counts_warm_entries_under_this_torch():
    assert tplan.probe_budget_s(600.0) == (600.0, "no warm plan entries")
    tplan.resolve_topk(rank=8, k=5, walk=lambda: "kernel", device="cpu")
    budget, why = tplan.probe_budget_s(600.0)
    assert budget == 120.0 and why.endswith(
        f"for torch {tcache._torch_version()}")


def test_disarmed_resolvers_touch_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV, "off")
    assert tplan.mode() == "off" and not tplan.armed()
    assert tplan.resolve_training(rank=8, compute_dtype="float32",
                                  label="x", walk=lambda: 1) is None
    assert tplan.resolve_topk(rank=8, k=5, walk=lambda: 1) is None
    assert tplan.resolve_kernel_config(rank=8, tune=True) is None
    assert not tplan.invalidate_kernel_config(rank=8)
    assert tplan.resolve_serving_buckets(observed=[3, 9]) == (4, 16)
    assert tobs.events() == []
    assert not (tmp_path / "plan").exists()


# -- the resolvers against the reference ------------------------------------

_SHAPES = [(1000, 500, 2, False), (162541, 59047, 4, True),
           (5, 3, 1, False), (70, 2000, 8, True), (1 << 20, 1 << 10, 3, False)]


@pytest.mark.parametrize("n_users,n_items,D,implicit", _SHAPES)
def test_shape_class_gather_model_and_strategy_as_the_reference(
        n_users, n_items, D, implicit):
    for args in ((), (n_users,), (None, n_items), (n_users, n_items, 7),
                 (0, n_items, n_users)):
        assert tplan.shape_class(*args) == jplan.shape_class(*args)
    kw = dict(n_users=n_users, n_items=n_items, rank=16, n_devices=D,
              implicit=implicit)
    assert tplan.gather_model(**kw) == jplan.gather_model(**kw)
    for req in ("auto", "ring", "all_to_all"):
        assert tplan.resolve_gather_strategy(requested=req, **kw) == \
            jplan.resolve_gather_strategy(requested=req, **kw)
    # 'auto' banked as provenance once per package, the verdict the model's
    comps = [c for _, d in tcache.list_entries() for c in d["components"]]
    assert comps.count(f"gather:D={D}") == 2
    assert [e["source"] for e in _evs(tobs, "plan_resolved")] == \
        [e["source"] for e in _evs(jobs, "plan_resolved")] == ["probe"]


@pytest.mark.parametrize("rank", [0, 16])
def test_observed_ladder_banked_then_read_back_as_the_reference(rank):
    seq = [("default", None), ("observed", [1, 1, 1, 2, 2, 3, 5, 9]),
           ("default", None), ("observed", [0, -1]), ("default", None),
           ("requested", (4, 16)), ("default", None)]
    got = {}
    for name, mod in (("port", tplan), ("ref", jplan)):
        out = []
        for what, arg in seq:
            kw = {} if what == "default" else {what: arg}
            out.append(mod.resolve_serving_buckets(rank=rank, **kw))
        got[name] = out
    assert got["port"] == got["ref"]
    assert got["port"][1:3] == [(2, 8, 16)] * 2
    assert got["port"][4] == (8, 32, 128)
    assert [(e["component"], e["source"])
            for e in _evs(tobs, "plan_resolved")] == \
        [(e["component"], e["source"])
         for e in _evs(jobs, "plan_resolved")]


def test_live_cadence_banked_and_read_back():
    first = tplan.resolve_live_cadence(rank=8)
    assert first == jplan.resolve_live_cadence(rank=8) == \
        tplan.DEFAULT_LIVE_CADENCE
    edited = {"max_batch": 64, "max_wait_ms": 5.0,
              "compact_delta_frac": 0.5, "compact_min_rows": 16}
    for mod, cache in ((tplan, tcache), (jplan, jcache)):
        key = mod.plan_key(rank=8, dtype="float32")
        doc = cache.load_entry(key)
        doc["components"]["live_cadence"]["resolved"] = edited
        cache.store_entry(key, doc)
    assert tplan.resolve_live_cadence(rank=8) == \
        jplan.resolve_live_cadence(rank=8) == edited
    assert tplan.resolve_live_cadence(
        rank=8, requested={"max_batch": 7}) == dict(
        tplan.DEFAULT_LIVE_CADENCE, max_batch=7)
    assert [e["source"] for e in _evs(tobs, "plan_resolved")] == \
        ["probe", "cache"]


def test_same_shaped_tenants_share_one_entry():
    from tpu_als_torch import tenancy

    rng = np.random.default_rng(0)
    eng = tenancy.MultiTenantEngine(device="cpu")
    for name in ("a", "b"):
        U = rng.normal(size=(32, 8)).astype(np.float32)
        V = rng.normal(size=(48, 8)).astype(np.float32)
        eng.add_tenant(tenancy.TenantSpec(name=name, k=5), U, V)
    files = [p for p, _ in tcache.list_entries()]
    assert len(files) == 1
    comps = tcache.list_entries()[0][1]["components"]
    assert set(comps) == {"serving_buckets", "live_cadence"}
    hits = _evs(tobs, "plan_cache_hit")
    assert [h["component"] for h in hits] == ["serving_buckets",
                                              "live_cadence"]
    for kw in ({"rank": 8, "n_users": 32, "n_items": 48},
               {"rank": 16, "requested_buckets": (4, 16)}):
        assert tplan.resolve_tenant_plan(**kw) == \
            jplan.resolve_tenant_plan(**kw)


# -- the fit: equivalence and off-is-free -----------------------------------

def _problem(seed=0, nU=40, nI=24, nnz=500):
    g = np.random.default_rng(seed)
    u, i = g.integers(0, nU, nnz), g.integers(0, nI, nnz)
    r = g.uniform(0.5, 5.0, nnz).astype(np.float32)
    return (build_csr_buckets(u, i, r, nU, min_width=4),
            build_csr_buckets(i, u, r, nI, min_width=4))


def _fit(ucsr, icsr, **kw):
    cfg = tals.AlsConfig(rank=8, max_iter=2, implicit_prefs=True,
                         alpha=4.0, reg_param=0.05, **kw)
    U, V = tals.train(ucsr, icsr, cfg, device="cpu")
    routes = [tals.resolve_solve_path(cfg, 8, b.width)
              for csr in (ucsr, icsr) for b in csr.buckets]
    return U, V, routes


def test_off_cold_and_warm_fit_the_same(monkeypatch, tmp_path):
    ucsr, icsr = _problem()
    monkeypatch.setenv(ENV, "off")
    U0, V0, r0 = _fit(ucsr, icsr)
    assert _types(tobs) == []
    monkeypatch.setenv(ENV, str(tmp_path / "plan"))
    trails = []
    for _ in range(2):
        tobs.reset()
        U, V, routes = _fit(ucsr, icsr)
        assert routes == r0 and set(r0) == {"gatherfused_solve"}
        assert torch.equal(U, U0) and torch.equal(V, V0)
        trails.append(_types(tobs))
    assert trails == [["plan_cache_miss", "plan_probe", "plan_resolved"],
                      ["plan_cache_hit", "plan_resolved"]]
    (entry,) = [d for _, d in tcache.list_entries()]
    (name, comp), = entry["components"].items()
    assert name.startswith("training:solve=auto,")
    assert comp["resolved"] == tals.training_walk(
        tals.AlsConfig(rank=8), 8) == {
        "resolved_solve_path": "gatherfused_solve",
        "wide_solve_path": "gatherfused+pallas_cholesky",
        "split_width": tals.SPLIT_WIDTH}
    model = comp["provenance"]["model"]
    assert model["ne_proposal"] == min(model["ne_bytes"],
                                       key=model["ne_bytes"].get)
    assert entry["probes"] == {} and \
        comp["provenance"]["probes_executed"] == []


def _bank_kernel_config(config, ucsr, icsr):
    """A kernel config banked through the planner's own search under the
    key a fit of ``(ucsr, icsr)`` reads, with an injected timer that
    makes ``config`` win."""
    space = {k: [v] for k, v in config.items()}
    return tplan.resolve_kernel_config(
        rank=8, tune=True, device="cpu", space=space,
        timer=lambda c: 1.0,
        shape_class=tplan.shape_class(ucsr.num_rows, icsr.num_rows,
                                      ucsr.nnz))


def test_banked_knobs_change_nothing_unless_autotune_is_on(monkeypatch):
    ucsr, icsr = _problem(seed=3)
    widths = sorted({b.width for b in ucsr.buckets + icsr.buckets})
    assert widths[-1] > 8
    U0, V0, r0 = _fit(ucsr, icsr)
    tuned = {"split_width": 8, "scratch_elems": 1 << 22}
    assert _bank_kernel_config(tuned, ucsr, icsr) == tuned
    grams = []
    real = cuda_gather_ne.gather_gram

    def counting(*a, **k):
        grams.append(a[1].shape[1])
        return real(*a, **k)

    monkeypatch.setattr(cuda_gather_ne, "gather_gram", counting)
    tobs.reset()
    U, V, routes = _fit(ucsr, icsr)
    assert routes == r0 and grams == []
    assert torch.equal(U, U0) and torch.equal(V, V0)
    assert "kernel_config" not in {e["component"]
                                   for e in _evs(tobs, "plan_resolved")}

    monkeypatch.setenv(tplan.AUTOTUNE_ENV, "1")
    tobs.reset()
    U, V, _ = _fit(ucsr, icsr)
    wide = [w for w in widths if w > 8]
    assert sorted(set(grams)) == wide
    for w in wide:
        assert tals.resolve_solve_path(tals.AlsConfig(rank=8), 8, w) == \
            "gatherfused_solve"
        assert tals.resolve_solve_path(tals.AlsConfig(rank=8), 8, w, 8) == \
            "gatherfused+pallas_cholesky"
    assert [(e["component"], e["source"])
            for e in _evs(tobs, "plan_resolved")][0] == \
        ("kernel_config", "cache")
    training = [e for _, d in tcache.list_entries()
                for n, e in d["components"].items()
                if n.startswith("training:")]
    assert {e["resolved"]["split_width"] for e in training} == \
        {tals.SPLIT_WIDTH, 8}
    assert torch.allclose(U, U0, rtol=1e-4, atol=1e-5)


def test_attributed_fit_takes_the_banked_knobs(monkeypatch):
    """Stage attribution armed and the gate on: the fit's fenced twin
    cuts its buckets at the banked split (each bucket's route is
    ``local_half_step``'s at that split, K3 launched on the wide ones)
    and its factors are the tuned ``als_step``'s within the twin's
    rtol 1e-5 (tests/test_torch_attribution.py's)."""
    from tpu_als_torch.obs import trace
    from tpu_als_torch.perf import attribution

    ucsr, icsr = _problem(seed=3)
    tuned = {"split_width": 8, "scratch_elems": 1 << 22}
    assert _bank_kernel_config(tuned, ucsr, icsr) == tuned
    monkeypatch.setenv(tplan.AUTOTUNE_ENV, "1")
    made = []
    real_make = attribution.make_attributed_step

    def keep(*a, **k):
        made.append(real_make(*a, **k))
        return made[-1]

    monkeypatch.setattr(attribution, "make_attributed_step", keep)
    grams = []
    real = cuda_gather_ne.gather_gram

    def counting(*a, **k):
        grams.append(a[1].shape[1])
        return real(*a, **k)

    monkeypatch.setattr(cuda_gather_ne, "gather_gram", counting)
    cfg = tals.AlsConfig(rank=8, max_iter=1, implicit_prefs=True,
                         alpha=4.0, reg_param=0.05)
    with trace.stage_attribution():
        U, V = tals.train(ucsr, icsr, cfg, device="cpu")
    (step,) = made
    want = {}
    for csr in (icsr, ucsr):
        for b in csr.buckets:
            p = tals.resolve_solve_path(cfg, 8, b.width, 8)
            want[p] = want.get(p, 0) + 1
    assert step.routes == want and "gatherfused+pallas_cholesky" in want
    assert sorted(set(grams)) == sorted({b.width for c in (ucsr, icsr)
                                         for b in c.buckets if b.width > 8})
    g = torch.Generator().manual_seed(int(cfg.seed))
    U0 = tals.init_factors(ucsr.num_rows, 8, g)
    V0 = tals.init_factors(icsr.num_rows, 8, g)
    Ut, Vt = tals.als_step(U0, V0, ucsr.to("cpu"), icsr.to("cpu"),
                           ucsr.num_rows, icsr.num_rows, cfg,
                           ucsr.chunk_elems, icsr.chunk_elems, tuned)
    np.testing.assert_allclose(U.numpy(), Ut.numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(V.numpy(), Vt.numpy(), rtol=1e-5, atol=0)


# -- the CLI's keys ---------------------------------------------------------

def _json(capsys):
    return json.loads(capsys.readouterr().out)


def test_cli_plan_show_warm_clear_keys_as_the_reference(capsys):
    from tpu_als.cli import main as jmain
    from tpu_als_torch.cli import main as tmain

    got = {}
    for name, main, dev in (("ref", jmain, []),
                            ("port", tmain, ["--device", "cpu"])):
        main(["plan", "warm", "--rank", "8", "--k", "5"] + dev)
        warm = _json(capsys)
        main(["plan", "show"])
        show = _json(capsys)
        main(["plan", "clear"])
        clear = _json(capsys)
        got[name] = (warm, show, clear)
    (jw, js, jc), (tw, ts, tc) = got["ref"], got["port"]
    assert set(tw) == set(jw)
    assert set(ts) == set(js) == {"mode", "cache_dir", "entries"}
    assert set(tc) == set(jc) == {"cleared_entries", "cache_dir"}
    # the port's show, taken before its clear, sees only its own entry
    assert [set(e) for e in ts["entries"]] == \
        [{"path", "plan_key", "probes", "components"}]
    comp_keys = {k for e in js["entries"] for c in e["components"].values()
                 for k in c}
    assert {k for e in ts["entries"] for c in e["components"].values()
            for k in c} == comp_keys
    assert tc["cleared_entries"] == 1 and tw["topk_backend"] == "kernel"
