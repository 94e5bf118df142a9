"""The port's linter (``tpu_als_torch/analysis/lint.py``) and its
vocabulary engine (``analysis/vocab.py``), against the reference's.

- Every rule the port carries has a fixture under
  ``tests/fixtures_torch_analysis/`` that fires it (and makes the linter
  exit nonzero) and one that stays silent; the rules not carried print
  their reason under ``--rules``.
- A suppression without a reason does not suppress; the baseline round-
  trips, and the port's own baseline is empty.
- The port's tree lints clean in under 10 s, and ``lint.py`` and
  ``vocab.py`` run as files with ``torch`` and ``jax`` both poisoned.
- Parity: on the reference's own fixtures for TAL007, TAL009, TAL011 and
  TAL012 (``tests/fixtures_analysis/``, read only) the port's engine
  reports those rules at the lines ``tpu_als/analysis/lint.py`` does,
  given the same registries, and on the port's own registries the
  reference's ok fixtures are finding-free too (``ok_unregistered_name.py``
  counts ``serve.requests``, which the port's sharded serve writes since
  ``parallel/serve.py`` took the reference's metrics) while its bad
  fixtures fire alike.
- The three faults the linter found in the port stay repaired:
  ``resilience/faults.py`` and ``obs/schema.py`` load by file path
  without torch or the package (and ``fault_injected`` is still emitted
  once obs is loaded), ``obs/trace.py``'s bracketing clock carries a
  reasoned suppression, and ``resilience/elastic.py`` names its fault
  point as a literal.
"""

import glob
import importlib.util
import os
import re
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures_torch_analysis")
REF_FIXTURES = os.path.join(REPO, "tests", "fixtures_analysis")
LINT = os.path.join(REPO, "tpu_als_torch", "analysis", "lint.py")
VOCAB = os.path.join(REPO, "tpu_als_torch", "analysis", "vocab.py")
BASELINE = os.path.join(REPO, "tpu_als_torch", "analysis",
                        "lint_baseline.txt")


def _load_standalone(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# by file path, never through the package: the doorway without torch
lint = _load_standalone("_tal_torch_lint_under_test", LINT)
ref_lint = _load_standalone(
    "_tal_ref_lint_under_test",
    os.path.join(REPO, "tpu_als", "analysis", "lint.py"))


def _fixture(name):
    return os.path.join(FIXTURES, name)


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def _poisoned_env(tmp_path):
    poison = tmp_path / "poison"
    poison.mkdir(exist_ok=True)
    for mod in ("torch", "jax", "numpy"):
        (poison / f"{mod}.py").write_text(
            f'raise ImportError("{mod} must not be imported here")\n')
    return {**_env(), "PYTHONPATH": str(poison)}


def _run(args, env=None, cwd=REPO):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=cwd, env=env or _env(),
                          timeout=120)


# -- the fixture corpus ------------------------------------------------------

RULE_CASES = [
    ("bad_parse_error.py", "parse-error"),
    ("bad_wallclock_rng.py", "wallclock-rng"),
    ("bad_dtype_drift.py", "dtype-drift"),
    ("bad_unregistered_name.py", "unregistered-name"),
    ("bad_magic_jitter.py", "magic-jitter"),
    ("bad_jaxfree_import.py", "jaxfree-import"),
    ("bad_timer_brackets_span.py", "timer-brackets-span"),
    ("bad_suppression.py", "bad-suppression"),
]


def test_corpus_covers_every_carried_rule():
    carried = set(lint.RULES) - set(lint.NOT_CARRIED)
    assert {rule for _, rule in RULE_CASES} == carried
    assert set(lint.NOT_CARRIED) == {"tracer-branch", "host-side-effect",
                                     "use-after-donation",
                                     "numpy-on-traced", "bare-jit"}
    # the catalog is the reference's, slug for slug and number for number
    assert {s: t for s, (t, _) in lint.RULES.items()} == \
        {s: t for s, (t, _) in ref_lint.RULES.items()}
    bad = {os.path.basename(p) for p in glob.glob(_fixture("bad_*.py"))}
    ok = {os.path.basename(p) for p in glob.glob(_fixture("ok_*.py"))}
    assert bad == {f for f, _ in RULE_CASES}
    assert ok == {"ok_" + f[4:] for f in bad}


@pytest.mark.parametrize("fname,rule", RULE_CASES)
def test_bad_fixture_fires_its_rule_and_exits_nonzero(fname, rule):
    findings, nfiles = lint.lint_paths([_fixture(fname)])
    assert nfiles == 1
    assert any(f.rule == rule for f in findings), \
        [(f.rule, f.msg) for f in findings]
    p = _run([LINT, "--paths", _fixture(fname), "--baseline", "none"])
    assert p.returncode == 1, p.stdout + p.stderr
    assert rule in p.stderr


@pytest.mark.parametrize("fname", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(FIXTURES,
                                                        "ok_*.py"))))
def test_ok_fixture_is_finding_free(fname):
    findings, nfiles = lint.lint_paths([_fixture(fname)])
    assert nfiles == 1
    assert not findings, [(f.rule, f.line, f.msg) for f in findings]


def test_suppression_without_reason_does_not_suppress():
    findings, _ = lint.lint_paths([_fixture("bad_suppression.py")])
    got = {(f.rule, f.line) for f in findings}
    # the reasonless comment is a finding AND its target survives
    assert ("bad-suppression", 6) in got and ("wallclock-rng", 6) in got
    assert ("bad-suppression", 10) in got            # the unknown rule


def test_rules_prints_the_reason_for_each_rule_not_carried():
    p = _run([LINT, "--rules"])
    assert p.returncode == 0, p.stderr
    lines = p.stdout.splitlines()
    assert len(lines) == 13
    for slug, reason in lint.NOT_CARRIED.items():
        tal = lint.RULES[slug][0]
        assert any(ln.startswith(tal) and slug in ln
                   and f"not carried: {reason}" in ln for ln in lines), slug


# -- the baseline ------------------------------------------------------------

def test_baseline_round_trip(tmp_path):
    baseline = tmp_path / "baseline.txt"
    bad = _fixture("bad_magic_jitter.py")

    p = _run([LINT, "--paths", bad, "--baseline", str(baseline),
              "--write-baseline"])
    assert p.returncode == 0, p.stderr
    assert "magic-jitter" in baseline.read_text()
    p = _run([LINT, "--paths", bad, "--baseline", str(baseline)])
    assert p.returncode == 0, p.stdout + p.stderr
    assert "1 baselined" in p.stdout
    # the finding is gone: a stale note, still exit 0
    p = _run([LINT, "--paths", _fixture("ok_magic_jitter.py"),
              "--baseline", str(baseline)])
    assert p.returncode == 0 and "stale baseline entry" in p.stderr
    baseline.unlink()
    p = _run([LINT, "--paths", bad, "--baseline", str(baseline)])
    assert p.returncode == 1 and "magic-jitter" in p.stderr


def test_the_ports_baseline_is_its_own_and_empty():
    assert os.path.abspath(lint.BASELINE_DEFAULT) == BASELINE
    with open(BASELINE) as f:
        entries = [ln for ln in f.read().splitlines()
                   if ln.strip() and not ln.startswith("#")]
    assert entries == []


# -- the port's tree ---------------------------------------------------------

def test_the_ports_tree_lints_clean_under_10s():
    t0 = time.monotonic()
    p = _run([LINT])
    dt = time.monotonic() - t0
    assert p.returncode == 0, p.stdout + p.stderr
    assert "tpu_als_torch lint: OK" in p.stdout
    assert dt < 10.0, f"lint took {dt:.1f}s"


def test_lint_and_vocab_run_with_torch_and_jax_poisoned(tmp_path):
    env = _poisoned_env(tmp_path)
    p = _run([LINT], env=env)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "tpu_als_torch lint: OK" in p.stdout
    p = _run([VOCAB], env=env)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "tpu_als_torch vocab: OK" in p.stdout
    p = _run([VOCAB, "--paths", _fixture("bad_unregistered_name.py")],
             env=env)
    assert p.returncode == 1 and "fixture.not_registered" in p.stderr


def test_stdlib_only_modules_declare_it():
    """The modules TAL010 holds to the standard library say so in the
    words the rule reads (and lint clean, above)."""
    for rel in ("analysis/lint.py", "analysis/vocab.py", "obs/schema.py",
                "plan/cache.py", "resilience/faults.py",
                "analysis/contracts.py", "soak/verdict.py",
                "scenario/spec.py"):
        with open(os.path.join(REPO, "tpu_als_torch", rel)) as f:
            assert lint._STDLIB_CLAIM_RE.search(f.read()[:4000]), rel


# -- parity with the reference's engine ----------------------------------------

PARITY_RULES = {"unregistered-name", "magic-jitter", "timer-brackets-span",
                "bad-suppression"}


def _engine_on_reference_registries():
    """The port's vocabulary engine holding the reference's registries
    (both stdlib-only, loaded by file path): engine parity, with the two
    schemas' differences held out."""
    vocab = lint._load_vocab()
    vocab._REGISTRY_CACHE[REPO] = (
        _load_standalone("_ref_schema", os.path.join(
            REPO, "tpu_als", "obs", "schema.py")),
        _load_standalone("_ref_faults", os.path.join(
            REPO, "tpu_als", "resilience", "faults.py")))
    return vocab


@pytest.mark.parametrize("stem", ["unregistered_name", "magic_jitter",
                                  "timer_brackets_span", "suppression"])
@pytest.mark.parametrize("kind", ["bad", "ok"])
def test_parity_on_the_references_fixtures(stem, kind):
    path = os.path.join(REF_FIXTURES, f"{kind}_{stem}.py")
    ours = lint.FileLinter(path, REPO,
                           _engine_on_reference_registries()).run()
    theirs, _ = ref_lint.lint_paths([path])
    pick = lambda fs: sorted((f.rule, f.line) for f in fs  # noqa: E731
                             if f.rule in PARITY_RULES)
    assert pick(ours) == pick(theirs)
    if kind == "bad":
        assert pick(ours), "the reference's bad fixture fired nothing here"
    # on the port's own registries the fixtures fire alike: the bad ones
    # their rules, the ok ones nothing
    own, _ = lint.lint_paths([path])
    assert pick(own) == pick(theirs)


# -- the three repairs ---------------------------------------------------------

_STANDALONE = r"""
import importlib.util, sys
for name in ("torch", "numpy", "jax", "tpu_als"):
    sys.modules[name] = None
mods = {}
for name, path in (("faults", sys.argv[1]), ("schema", sys.argv[2])):
    spec = importlib.util.spec_from_file_location("_s_" + name, path)
    mods[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mods[name])
f = mods["faults"]
f.install("solve.gram=corrupt@once")
assert f.check("solve.gram") == "corrupt"
assert "fault_injected" in mods["schema"].EVENTS
bad = [m for m in sys.modules if m.startswith("tpu_als_torch")]
assert not bad, bad
print("ok")
"""


def test_faults_and_schema_load_by_file_path_without_torch():
    p = _run(["-c", _STANDALONE,
              os.path.join(REPO, "tpu_als_torch", "resilience", "faults.py"),
              os.path.join(REPO, "tpu_als_torch", "obs", "schema.py")])
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "ok"


def test_fault_injected_is_still_emitted_once_obs_is_loaded():
    from tpu_als_torch import obs
    from tpu_als_torch.resilience import faults

    obs.reset()
    faults.install("solve.gram=corrupt@nth=2")
    try:
        assert faults.check("solve.gram") is None
        assert faults.check("solve.gram") == "corrupt"
    finally:
        faults.clear()
    ev = obs.events("fault_injected")
    assert [(e["point"], e["mode"], e["hit"]) for e in ev] == \
        [("solve.gram", "corrupt", 2)]
    obs.reset()


def test_stage_clock_suppression_is_reasoned():
    trace_py = os.path.join(REPO, "tpu_als_torch", "obs", "trace.py")
    with open(trace_py) as f:
        assert "tal: disable=timer-brackets-span -- deliberate" in f.read()
    findings, _ = lint.lint_paths([trace_py])
    assert not findings, [(f.rule, f.line) for f in findings]


def test_elastic_fault_point_is_a_literal():
    elastic_py = os.path.join(REPO, "tpu_als_torch", "resilience",
                              "elastic.py")
    with open(elastic_py) as f:
        src = f.read()
    sites = re.findall(r"faults\.check\(([^)]*)\)", src)
    assert sites == ['"mesh.device_lost"'], sites
    findings, _ = lint.lint_paths([elastic_py])
    assert not findings, [(f.rule, f.line, f.msg) for f in findings]


# -- the command line ------------------------------------------------------------

def test_cli_lint_propagates_the_exit_code():
    env = {**_env(), "OMP_NUM_THREADS": "1"}
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['tpu_als'] = None; "
            "from tpu_als_torch.cli import main; "
            "sys.exit(main(sys.argv[1:]))")
    bad = _run(["-c", code, "lint", "--paths",
                _fixture("bad_dtype_drift.py"), "--baseline", "none"],
               env=env)
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert "dtype-drift" in bad.stderr
    ok = _run(["-c", code, "lint", "--paths", _fixture("ok_dtype_drift.py"),
               "--baseline", "none"], env=env)
    assert ok.returncode == 0, ok.stdout + ok.stderr
