"""The port's contract registry (``tpu_als_torch/analysis/contracts.py``).

- Ten contracts resolve by name, each naming the test that owns its
  full-strength pin, and every one verifies on the CPU
  (``--device cpu``: the kernels' plain versions).
- Each has a red path: an operation added to the step only when armed
  fails ``guardrails_disarmed``, ``tracing_disarmed`` and
  ``elastic_disarmed``; a cache that changes the step fails
  ``plan_cache_off``; a doctored bank fails ``floor_audit``; a permuted
  tie fails ``serve_comm_audit``; audited bytes off the model fail
  ``comm_audit``; declared bytes off the closed forms fail ``ne_audit``
  and ``fused_solve_audit``; an index off the rebuild fails
  ``live_delta_index``.
- ``ring_substrate`` is refused with its reason; ``lint --contracts``
  without CUDA raises.
"""

import json
import os

import pytest
import torch

from tpu_als_torch.analysis import contracts
from tpu_als_torch.cli import main as cli_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OK_FIXTURE = os.path.join(REPO, "tests", "fixtures_torch_analysis",
                          "ok_magic_jitter.py")
NAMES = ("ne_audit", "fused_solve_audit", "guardrails_disarmed",
         "tracing_disarmed", "plan_cache_off", "comm_audit",
         "live_delta_index", "serve_comm_audit", "elastic_disarmed",
         "floor_audit")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny tensors under the suite's
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ten_contracts_resolve_by_name():
    assert contracts.names() == NAMES
    for name in NAMES:
        c = contracts.get(name)
        assert c.name == name
        assert c.provenance.startswith("tests/test_torch_")
        assert os.path.exists(os.path.join(REPO, c.provenance))
    with pytest.raises(KeyError, match="no contract named"):
        contracts.get("bogus")


@pytest.mark.parametrize("name", NAMES)
def test_contract_verifies_on_the_cpu(name):
    r = contracts.verify(name, device="cpu")
    assert r.ok, r.detail


# -- red paths ---------------------------------------------------------------

@pytest.mark.parametrize("name,armed", [
    ("guardrails_disarmed",
     lambda: __import__("tpu_als_torch.resilience.guardrails",
                        fromlist=["x"]).guardrails_mode() != "off"),
    ("tracing_disarmed",
     lambda: __import__("tpu_als_torch.obs.tracing",
                        fromlist=["x"]).tracing_armed()),
])
def test_an_op_added_under_arming_fails_the_signature(name, armed,
                                                      monkeypatch):
    from tpu_als_torch.core import als as core_als

    step = core_als.als_step

    def leaky(U, V, *a, **kw):
        if armed():
            torch.isfinite(U).all()      # one op the disarmed step lacks
        return step(U, V, *a, **kw)

    monkeypatch.setattr(core_als, "als_step", leaky)
    r = contracts.verify(name, device="cpu")
    assert not r.ok and "changed the step signature" in r.detail, r.detail


def test_a_cache_that_changes_the_step_fails_plan_cache_off(monkeypatch):
    from tpu_als_torch.core import als as core_als
    from tpu_als_torch.plan.cache import ENV_VAR

    step = core_als.als_step

    def steered(U, V, *a, **kw):
        if os.environ.get(ENV_VAR) != "off":
            U = U.clone()
        return step(U, V, *a, **kw)

    monkeypatch.setattr(core_als, "als_step", steered)
    r = contracts.verify("plan_cache_off", device="cpu")
    assert not r.ok and "changed the step signature" in r.detail, r.detail


def test_an_op_added_by_the_elastic_wrapper_fails(monkeypatch):
    from tpu_als_torch.resilience import elastic

    wrap = elastic.wrap_step

    def leaky(step, mesh, **kw):
        inner = wrap(step, mesh, **kw)

        def elastic_step(U, V, *a):
            torch.isfinite(U).all()
            return inner(U, V, *a)
        return elastic_step

    monkeypatch.setattr(elastic, "wrap_step", leaky)
    r = contracts.verify("elastic_disarmed", device="cpu")
    assert not r.ok and "changed the step signature" in r.detail, r.detail


@pytest.mark.parametrize("field,value,match", [
    ("tuned_seconds", 1e3, "SLOWER"),
    ("model_seconds", 1.0, "model_seconds"),
    ("value", 7.5, "speedup"),
])
def test_a_doctored_bank_fails_floor_audit(field, value, match, tmp_path,
                                           monkeypatch):
    bank = tmp_path / "bank.json"
    monkeypatch.setenv("TPU_ALS_PLAN_CACHE", str(tmp_path / "plan"))
    contracts._tune_bank(torch.device("cpu"), str(bank))
    monkeypatch.setenv(contracts.FLOOR_AUDIT_BANK_ENV, str(bank))
    assert contracts.verify("floor_audit", device="cpu").ok
    doc = json.loads(bank.read_text())
    doc[field] = value
    bank.write_text(json.dumps(doc))
    r = contracts.verify("floor_audit", device="cpu")
    assert not r.ok and match in r.detail, r.detail


def test_a_permuted_tie_fails_serve_comm_audit(monkeypatch):
    from tpu_als_torch.ops import cuda_topk

    plain = cuda_topk.topk_merge_ring_plain

    def permuted(*a, **kw):
        s, ix = plain(*a, **kw)
        # swap the first tied pair of some row: same scores, other order
        for row in range(s.shape[0]):
            tied = (s[row, 1:] == s[row, :-1]).nonzero()
            if len(tied):
                j = int(tied[0])
                ix = ix.clone()
                ix[row, [j, j + 1]] = ix[row, [j + 1, j]]
                break
        return s, ix

    monkeypatch.setattr(cuda_topk, "topk_merge_ring_plain", permuted)
    r = contracts.verify("serve_comm_audit", device="cpu")
    assert not r.ok and "tie ORDER" in r.detail, r.detail


def test_audited_bytes_off_the_model_fail_comm_audit():
    a = {"rows": [[{"strategy": s, "implicit": imp, "audited": 100,
                    "model": 100}
                   for s in ("all_gather", "all_gather_chunked", "ring",
                             "ring_overlap", "all_to_all")
                   for imp in (False, True)]] * 2,
         "processes": 2, "ring": 5, "ring_model": 5, "ring_calls": 1,
         "ring_launches": 0, "device": "cpu"}
    assert "audited == modeled" in contracts._pin_comm_audit(a)
    a["rows"][1] = [dict(x, audited=x["audited"] + 1) for x in a["rows"][1]]
    with pytest.raises(contracts.ContractViolation, match="audited"):
        contracts._pin_comm_audit(a)


def test_declared_bytes_off_the_closed_forms_fail(monkeypatch):
    from tpu_als_torch.ops import cuda_gather_ne

    monkeypatch.setattr(cuda_gather_ne, "fused_ne_kernel_bytes",
                        lambda *a: 1)
    monkeypatch.setattr(cuda_gather_ne, "fused_solve_kernel_bytes",
                        lambda *a: 1)
    for name in ("ne_audit", "fused_solve_audit"):
        r = contracts.verify(name, device="cpu")
        assert not r.ok and "declared" in r.detail, (name, r.detail)


def test_an_index_off_the_rebuild_fails_live_delta_index():
    a = contracts._build_live_delta("cpu")
    a["compacted"].valid = a["compacted"].valid.clone()
    a["compacted"].valid[0] = ~a["compacted"].valid[0]
    with pytest.raises(contracts.ContractViolation):
        contracts._pin_live_delta(a)


# -- refusals and the command line -----------------------------------------------

def test_ring_substrate_is_refused_with_its_reason(capsys):
    assert "ring_substrate" not in contracts.names()
    with pytest.raises(KeyError, match="not carried"):
        contracts.get("ring_substrate")
    with pytest.raises(SystemExit) as e:
        cli_main(["lint", "--paths", OK_FIXTURE, "--baseline", "none",
                  "--contract", "ring_substrate", "--device", "cpu"])
    assert e.value.code == 1
    err = capsys.readouterr().err
    assert "contract ring_substrate: REFUSED" in err
    assert "ops/ring_buffer.py" in err


def test_lint_contracts_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        cli_main(["lint", "--paths", OK_FIXTURE, "--baseline", "none",
                  "--contracts"])


def test_cli_lint_contract_by_name_on_the_cpu(capsys):
    rc = cli_main(["lint", "--paths", OK_FIXTURE, "--baseline", "none",
                   "--contract", "live_delta_index", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "contract live_delta_index: OK" in out
    assert "tpu_als_torch lint --contracts: OK (1 verified)" in out
