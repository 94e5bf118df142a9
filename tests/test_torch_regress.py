"""The port's bench regression gate (``obs/regress.py``, ``observe
regress``) against ``tpu_als.obs.regress``.

Both packages' ``check()`` read the same synthetic banks in
``tmp_path`` and must give the same findings and exit codes (0 clean, 1
regression, 2 null bank, 3 provenance), with and without ``--trend``;
``render`` gives the same text; the port's module runs as a file on its
own with neither torch nor jax importable; the committed banks at the
repo root gate clean.  Every comparison is exact.
"""

import json
import os
import subprocess
import sys

import pytest

from tpu_als.obs import regress as jregress
from tpu_als_torch.cli import main as tmain
from tpu_als_torch.obs import regress as tregress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(d, name, doc):
    with open(os.path.join(str(d), name), "w") as f:
        json.dump(doc, f)


def _round(n, value, unit="iters/sec", **extra):
    return {"n": n, "cmd": "bench", "rc": 0, "tail": "",
            "parsed": {"metric": "m", "value": value, "unit": unit,
                       **extra}}


def _series(d, vals, unit="iters/sec", name="BENCH"):
    for n, v in enumerate(vals, 1):
        _write(d, f"{name}_r{n:02d}.json", _round(n, v, unit=unit))


def _fallback(d):
    _write(d, "BENCH_r01.json", _round(1, 1.0))
    doc = _round(2, None)
    doc["parsed"]["last_builder_measured"] = {"value": 0.99}
    _write(d, "BENCH_r02.json", doc)


def _multichip(d, oks):
    for n, ok in enumerate(oks, 1):
        _write(d, f"MULTICHIP_r{n:02d}.json",
               {"n_devices": 4, "rc": 0 if ok else 124, "ok": ok,
                "skipped": False})


def _bank(d, stamp):
    doc = {"metric": "serve_e2e_p99_ms", "value": 31.6, "unit": "ms"}
    if stamp is not None:
        doc["banked_at"] = stamp
    _write(d, "BENCH_serve.json", doc)


def _unreadable(d):
    with open(os.path.join(str(d), "BENCH_r01.json"), "w") as f:
        f.write("{not json")
    _write(d, "BENCH_weird.json", {"something": "else"})


SCENARIOS = {
    "clean": (lambda d: _series(d, [1.0, 0.98]), 0),
    "regression": (lambda d: _series(d, [1.0, 0.98, 0.8]), 1),
    "lower_better": (lambda d: _series(d, [30.0, 45.0], unit="ms"), 1),
    "latest_null": (lambda d: _series(d, [1.0, None]), 2),
    "historical_null": (lambda d: _series(d, [1.0, None, 1.02]), 0),
    "sweep_fallback": (_fallback, 0),
    "no_provenance": (lambda d: _bank(d, None), 3),
    "naive_stamp": (lambda d: _bank(d, "2026-08-05T11:14:02"), 3),
    "aware_stamp": (lambda d: _bank(d, "2026-08-05T11:14:02+00:00"), 0),
    "multichip_failing": (lambda d: _multichip(d, [True, False]), 1),
    "unreadable": (_unreadable, 2),
    "masked_slide": (lambda d: _series(d, [10.0, 9.2, 8.6, 8.0, 9.2]), 0),
    "rising_latency": (lambda d: _series(d, [8.0, 8.6, 9.2, 10.0],
                                         unit="ms"), 1),
}


@pytest.mark.parametrize("trend", [False, True])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_check_equals_the_reference(name, trend, tmp_path):
    make, plain_code = SCENARIOS[name]
    make(tmp_path)
    for kw in ({}, {"strict": True}, {"noise": 0.3}):
        mine = tregress.check(str(tmp_path), trend=trend, **kw)
        theirs = jregress.check(str(tmp_path), trend=trend, **kw)
        assert mine == theirs
        assert tregress.render(mine) == jregress.render(theirs)
    code = tregress.check(str(tmp_path), trend=trend)["exit_code"]
    if not trend:
        assert code == plain_code
    elif name == "masked_slide":
        assert code == tregress.EXIT_REGRESSION     # the slide it catches


def test_exit_codes_are_the_references():
    assert (tregress.EXIT_OK, tregress.EXIT_REGRESSION,
            tregress.EXIT_NULL_BANK, tregress.EXIT_PROVENANCE) == \
        (jregress.EXIT_OK, jregress.EXIT_REGRESSION,
         jregress.EXIT_NULL_BANK, jregress.EXIT_PROVENANCE) == (0, 1, 2, 3)


def test_committed_banks_gate_clean():
    for trend in (False, True):
        result = tregress.check(REPO, trend=trend)
        assert result["exit_code"] == 0
        assert result == jregress.check(REPO, trend=trend)


def test_cli_exit_codes(tmp_path, capsys):
    _series(tmp_path, [1.0, 1.01])
    out = tmain(["observe", "regress", str(tmp_path), "--json"])
    assert out["exit_code"] == 0
    assert json.loads(capsys.readouterr().out) == out
    _series(tmp_path, [1.0, 1.01, 0.5])
    with pytest.raises(SystemExit) as e:
        tmain(["observe", "regress", str(tmp_path)])
    assert e.value.code == 1
    assert "verdict: REGRESSION (exit 1)" in capsys.readouterr().out
    _series(tmp_path, [10.0, 9.2, 8.6, 8.0, 9.2])
    tmain(["observe", "regress", str(tmp_path)])
    with pytest.raises(SystemExit) as e:
        tmain(["observe", "regress", str(tmp_path), "--trend"])
    assert e.value.code == 1


def test_runs_as_a_file_without_torch_or_jax(tmp_path):
    _series(tmp_path, [1.0, None])
    code = ("import importlib.util, sys\n"
            "sys.modules['torch'] = None\nsys.modules['jax'] = None\n"
            "spec = importlib.util.spec_from_file_location('r', sys.argv[1])\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "sys.exit(m.check(sys.argv[2])['exit_code'])\n")
    p = subprocess.run([sys.executable, "-c", code,
                        os.path.join(REPO, "tpu_als_torch", "obs",
                                     "regress.py"), str(tmp_path)],
                       capture_output=True, text=True)
    assert p.returncode == 2, p.stderr
