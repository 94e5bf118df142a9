"""Declarative chaos schedule: every fault point, on the soak timeline.

Counterpart of ``tpu_als/soak/chaos.py`` over the port's fault harness
(``tpu_als_torch/resilience/faults.py``: ``push_spec`` / ``pop_spec``):
the same windows, actions and placement, so :meth:`ChaosSchedule.
describe` prints the reference's text.  The two CLI-child actions run
the port's ``train`` on the parent's ``--device`` (``soak/
orchestrator.py``).

A :class:`ChaosSchedule` sequences the repo's whole chaos vocabulary —
``serving.publish`` torn publishes, ``ingest.record`` stream poison,
``solve.gram`` solver blowups, ``mesh.device_lost`` device loss,
SIGTERM preemption, tenant register/remove — onto soak windows.  Each
:class:`ChaosWindow` names the window it lands in, an optional
``TPU_ALS_FAULT_SPEC`` grammar string armed for exactly that window
(``faults.push_spec`` overlay, popped in a ``finally`` — the same LIFO
restore discipline the scenario runner uses for per-phase specs), and
an ``action`` the orchestrator performs while the spec is armed.

Actions are the vocabulary of things a fault spec alone cannot do:

==================  ========================================================
``torn_publish``    republish the victim's factors while ``serving.publish``
                    corrupt is armed (the int8 index tags stale; recovery is
                    the next clean publish)
``poisoned_refit``  the window's periodic refit ingests its accumulated
                    ratings through ``stream_ingest`` with ``ingest.record``
                    armed — recovery is quarantine-and-complete
``solver_rollback`` a guardrails=recover re-fit with ``solve.gram`` corrupt
                    armed — recovery is sentinel-trip → rollback → publish
``tenant_churn``    register a short-lived tenant under load, serve it,
                    remove it (publish-before-visible under chaos)
``preempt``         a CLI train child gets SIGTERM'd at an iteration
                    boundary (exit 43) and ``--resume auto`` completes
``device_loss``     a CLI ``--elastic`` train child loses a device
                    (``mesh.device_lost`` in the CHILD's env), re-forms the
                    mesh and completes
==================  ========================================================

Every fault spec is validated at construction (``faults.parse_spec``) —
a typo fails the schedule, not minute three of the soak.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

from tpu_als_torch.resilience import faults

ACTIONS = ("torn_publish", "poisoned_refit", "solver_rollback",
           "tenant_churn", "preempt", "device_loss")


@dataclass(frozen=True)
class ChaosWindow:
    """One scheduled injection: which window, what to arm, what to do,
    and which tenant takes the hit (``victim=None`` = nobody — the
    verdict's victim-free-tenants-stay-clean check keys on this)."""

    window: int
    name: str
    fault_spec: str = None
    action: str = None
    victim: str = None
    doc: str = ""

    def __post_init__(self):
        if self.action is not None and self.action not in ACTIONS:
            raise ValueError(
                f"chaos window {self.name!r}: unknown action "
                f"{self.action!r} (known: {ACTIONS})")
        if self.fault_spec:
            faults.parse_spec(self.fault_spec)   # fail at construction


class ChaosSchedule:
    """An immutable window → injections map with scoped arming."""

    def __init__(self, windows=()):
        self.windows = tuple(windows)
        self._by_window = {}
        for cw in self.windows:
            self._by_window.setdefault(cw.window, []).append(cw)

    def __len__(self):
        return len(self.windows)

    def for_window(self, w):
        """The injections scheduled in window ``w`` (possibly empty)."""
        return tuple(self._by_window.get(w, ()))

    def victims(self, w):
        """Tenant names any window-``w`` injection targets."""
        return tuple(sorted({cw.victim for cw in self.for_window(w)
                             if cw.victim}))

    @contextlib.contextmanager
    def armed(self, w):
        """Push every window-``w`` fault spec (overlay over whatever is
        already armed), yield, pop them LIFO — failures included."""
        pushed = 0
        try:
            for cw in self.for_window(w):
                if cw.fault_spec:
                    faults.push_spec(cw.fault_spec)
                    pushed += 1
            yield
        finally:
            while pushed:
                faults.pop_spec()
                pushed -= 1

    def describe(self):
        """One line per injection — what `tpu_als_torch soak --plan`
        prints."""
        lines = []
        for cw in sorted(self.windows, key=lambda c: (c.window, c.name)):
            bits = [f"window {cw.window}: {cw.name}"]
            if cw.action:
                bits.append(f"action={cw.action}")
            if cw.fault_spec:
                bits.append(f"spec={cw.fault_spec!r}")
            if cw.victim:
                bits.append(f"victim={cw.victim}")
            lines.append("  ".join(bits))
        return "\n".join(lines)


def default_schedule(windows, victim="a", subprocesses=True):
    """The production-week placement, scaled to ``windows``: window 0
    stays clean (warmup), the chaos vocabulary lands in order across
    the middle windows, and the last window stays clean (cooldown —
    the verdict's recovery evidence must fit inside the timeline).
    ``subprocesses=False`` drops the two CLI-child injections (preempt,
    device_loss) for fast in-process runs."""
    seq = [
        ChaosWindow(0, "torn-publish", victim=victim,
                    fault_spec="serving.publish=corrupt@once",
                    action="torn_publish",
                    doc="republish tags the victim's int8 index stale; "
                        "requests degrade to the exact path until the "
                        "clean republish"),
        ChaosWindow(0, "poisoned-refit", victim=victim,
                    fault_spec="ingest.record=corrupt@every=5",
                    action="poisoned_refit",
                    doc="the periodic refit's ingest is poisoned every "
                        "5th record; quarantine routes them aside and "
                        "the refit completes"),
        ChaosWindow(0, "solver-rollback", victim=victim,
                    fault_spec="solve.gram=corrupt@nth=2",
                    action="solver_rollback",
                    doc="a guardrails=recover re-fit hits a blown Gram "
                        "solve; sentinel trips, rolls back, publishes"),
        ChaosWindow(0, "tenant-churn", action="tenant_churn",
                    doc="a short-lived tenant registers, serves, and is "
                        "removed while the fleet is under load"),
    ]
    if subprocesses:
        seq.append(ChaosWindow(
            0, "preempt", victim=victim, action="preempt",
            doc="a CLI train child is preempted at an iteration "
                "boundary (exit 43); --resume auto completes"))
        seq.append(ChaosWindow(
            0, "device-loss", victim=victim, action="device_loss",
            doc="an elastic train child loses a device mid-fit; the "
                "ring re-forms on the survivors and the fit completes"))
    # place them across windows 1..windows-2, round-robin if the
    # timeline is shorter than the vocabulary
    slots = max(1, windows - 2)
    placed = []
    for i, cw in enumerate(seq):
        w = 1 + (i % slots)
        placed.append(ChaosWindow(w, cw.name, cw.fault_spec, cw.action,
                                  cw.victim, cw.doc))
    return ChaosSchedule(placed)
