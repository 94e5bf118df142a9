#!/usr/bin/env python
"""The port's linter: invariants otherwise kept by hand, mechanized as
named AST rules.

Counterpart of ``tpu_als/analysis/lint.py`` (rules TAL000-TAL012).  The
reference's rules guard tracing semantics; eager torch traces nothing,
so the port carries the rules that keep their meaning and gives two
tracing rules a torch counterpart:

    TAL000 parse-error           file does not parse
    TAL003 wallclock-rng         torch random call without generator= /
                                 torch.manual_seed (explicit generators)
    TAL005 dtype-drift           float16/bfloat16 cast or TF32 switched on
                                 outside a dtype gate
    TAL007 unregistered-name     obs/fault literal bypassing the registries
    TAL009 magic-jitter          hardcoded 1e-6 jitter escaping DEFAULT_JITTER
    TAL010 jaxfree-import        the port importing jax / tpu_als, or a
                                 'Deliberately stdlib-only' module importing
                                 anything outside the standard library
    TAL011 timer-brackets-span   perf_counter window brackets an obs.span
    TAL012 bad-suppression       'tal: disable' without a reason / unknown rule

Not carried (``--rules`` prints each with its reason, and their slugs
stay valid in a suppression): TAL001 tracer-branch, TAL002
host-side-effect, TAL004 use-after-donation, TAL006 numpy-on-traced and
TAL008 bare-jit.

Suppression syntax, the reference's (the reason is mandatory)::

    something_flagged()  # tal: disable=dtype-drift -- why this is ok

A suppression comment on its own line applies to the next code line.
The baseline, ``tpu_als_torch/analysis/lint_baseline.txt`` (``path ::
rule :: message`` a line), is the port's own and is kept EMPTY by
policy: a finding is fixed or suppressed at its site with a reason.

Deliberately stdlib-only: runnable as a file (``python
tpu_als_torch/analysis/lint.py``) with neither torch nor jax importable;
its sibling ``vocab.py`` (rule unregistered-name) is loaded by file path,
never through the package root, which imports torch.  ``--contracts`` is
the one doorway to torch: it imports
:mod:`tpu_als_torch.analysis.contracts` and verifies the registry on
``--device`` (default the card; ``cpu`` asks for the CPU).
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# tpu_als_torch/analysis/lint.py -> repo root
REPO = os.path.dirname(os.path.dirname(HERE))

RULES = {
    "parse-error": ("TAL000", "file does not parse"),
    "tracer-branch": (
        "TAL001",
        "Python if/while/assert on a traced value inside traced code"),
    "host-side-effect": (
        "TAL002", "host side effect inside traced code"),
    "wallclock-rng": (
        "TAL003",
        "torch random call without an explicit generator= (or "
        "torch.manual_seed): draws from the global RNG, which any other "
        "caller moves; pass a torch.Generator, inject initial factors"),
    "use-after-donation": (
        "TAL004", "read of a buffer after it was donated to a jitted call"),
    "dtype-drift": (
        "TAL005",
        "float16/bfloat16 cast or TF32 switched on with no dtype gate — "
        "the port computes in full float32 unless the caller's dtype asks "
        "otherwise (utils/platform.py pin_fp32; ops/solve.py's gate)"),
    "numpy-on-traced": ("TAL006", "np.* call on a traced array"),
    "unregistered-name": (
        "TAL007",
        "obs metric/event/fault-point literal bypassing the schema "
        "registries"),
    "bare-jit": (
        "TAL008", "jax.jit built inside a plain function body"),
    "magic-jitter": (
        "TAL009",
        "hardcoded 1e-6 jitter literal — thread "
        "tpu_als_torch.ops.solve.DEFAULT_JITTER / AlsConfig.jitter "
        "instead"),
    "jaxfree-import": (
        "TAL010",
        "the port imports jax or tpu_als, or a module declared "
        "'Deliberately stdlib-only' imports torch, numpy or the package "
        "(whose __init__ imports torch) at module level; load registries "
        "standalone by file path"),
    "timer-brackets-span": (
        "TAL011",
        "perf_counter window brackets an obs.span enter/exit, so span "
        "emission (JSONL writes) pollutes the measurement; start the "
        "clock inside the span"),
    "bad-suppression": (
        "TAL012",
        "'tal: disable' comment without a '-- reason' or naming an "
        "unknown rule"),
}

#: The reference's rules without a torch counterpart, and why.
NOT_CARRIED = {
    "tracer-branch": "eager torch traces nothing: a Python branch on a "
                     "tensor runs on every call (a host sync at worst), "
                     "it never freezes at trace time",
    "host-side-effect": "eager torch traces nothing: a print or a file "
                        "write runs on every call, not once at trace time",
    "use-after-donation": "the port donates no buffer (neither jax.jit "
                          "nor torch.compile); K6 writing L over its "
                          "input A is pinned by its own tests",
    "numpy-on-traced": "no traced values: numpy on a CPU tensor is an "
                       "explicit host copy, and on a CUDA tensor it "
                       "raises",
    "bare-jit": "the port uses neither jax.jit nor torch.compile; "
                "dispatch decisions go through tpu_als_torch.plan",
}

DEFAULT_ROOTS = ("tpu_als_torch", "chip_smoke.py")
BASELINE_DEFAULT = os.path.join(HERE, "lint_baseline.txt")

_STDLIB_CLAIM_RE = re.compile(r"(?i)\bdeliberately\s+stdlib[-\s]only\b")

_SUPPRESS_RE = re.compile(
    r"#\s*tal:\s*disable=(?P<rules>[A-Za-z0-9_,\-]+)"
    r"(?P<sep>\s*--\s*)?(?P<reason>.*)?$")

# torch's random draws: without generator= they read the global RNG
_RANDOM_CALLS = {
    "torch." + n for n in (
        "rand", "randn", "randint", "randperm", "normal", "bernoulli",
        "multinomial", "poisson", "rand_like", "randn_like",
        "randint_like")}
_RANDOM_METHODS = {"normal_", "uniform_", "random_", "bernoulli_",
                   "exponential_", "geometric_", "log_normal_", "cauchy_"}
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                 "torch.cuda.manual_seed_all", "torch.random.manual_seed"}
_LOW = ("float16", "bfloat16", "half")


class Finding:
    __slots__ = ("path", "line", "rule", "msg")

    def __init__(self, path, line, rule, msg):
        self.path, self.line, self.rule, self.msg = path, line, rule, msg

    @property
    def key(self):
        return f"{self.path} :: {self.rule} :: {self.msg}"

    def render(self):
        tal = RULES[self.rule][0]
        return f"{self.path}:{self.line}: {self.rule} [{tal}]: {self.msg}"


def _dotted(node, aliases):
    """Resolve an Attribute/Name chain to a dotted path with import
    aliases expanded; None for anything not a plain chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def _aliases(nodes):
    out = {}
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _functions(nodes):
    return [n for n in nodes
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _walk_own(node):
    """Every node of ``node``'s body (a function's or the module's), not
    descending into nested definitions (those are visited as functions
    of their own)."""
    stack = list(node.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _imported(node):
    """The module names an import statement brings in ('.x' for a
    relative import)."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom):
        if node.level:
            return ["." + (node.module or "")]
        if node.module:
            return [node.module]
    return []


class FileLinter:
    def __init__(self, path, repo=REPO, vocab=None):
        self.path = path
        self.rel = os.path.relpath(path, repo).replace(os.sep, "/")
        self.repo = repo
        self.vocab = vocab
        self.findings = []
        with open(path, encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()

    def add(self, line, rule, msg):
        self.findings.append(Finding(self.rel, line, rule, msg))

    # -- suppression comments ------------------------------------------
    def _suppressions(self):
        """Map line -> set(rule slugs) from ``# tal: disable=`` comments;
        malformed comments become bad-suppression findings."""
        by_line = {}
        for i, raw in enumerate(self.lines, 1):
            m = _SUPPRESS_RE.search(raw)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",")
                     if r.strip()}
            reason = (m.group("reason") or "").strip()
            if not m.group("sep") or not reason:
                self.add(i, "bad-suppression",
                         "suppression without a reason — write "
                         "'# tal: disable=<rule> -- <why this is ok>'")
                continue
            unknown = sorted(r for r in rules if r not in RULES)
            if unknown:
                self.add(i, "bad-suppression",
                         f"unknown rule(s) {', '.join(unknown)} in "
                         "suppression (see tpu_als_torch lint --rules)")
                rules -= set(unknown)
            target = i
            if raw.lstrip().startswith("#"):
                # own-line comment: applies to the next code line
                # (skipping blank/comment continuation lines)
                target = i + 1
                while target <= len(self.lines) and (
                        not self.lines[target - 1].strip()
                        or self.lines[target - 1].lstrip()
                        .startswith("#")):
                    target += 1
            by_line.setdefault(target, set()).update(rules)
        return by_line

    # -- the rules -----------------------------------------------------
    def run(self):
        suppressions = self._suppressions()
        try:
            tree = ast.parse(self.text)
        except SyntaxError as e:
            self.add(e.lineno or 1, "parse-error", str(e.msg))
            return self.findings
        nodes = list(ast.walk(tree))     # one walk, shared by the rules
        aliases = _aliases(nodes)

        self._rule_isolation(tree, nodes)
        self._rule_magic_jitter(nodes, aliases)
        self._rule_timer_brackets_span(nodes, aliases)
        self._rule_explicit_rng(nodes, aliases)
        self._rule_dtype_drift(tree, _functions(nodes), aliases)
        if self.vocab is not None:
            for lineno, msg in self.vocab.check_file(self.path,
                                                     self.repo):
                prefix = f"{os.path.relpath(self.path, self.repo)}:{lineno}: "
                if msg.startswith(prefix):
                    msg = msg[len(prefix):]
                self.add(lineno, "unregistered-name", msg)

        self.findings = [
            f for f in self.findings
            if f.rule == "bad-suppression"
            or f.rule not in suppressions.get(f.line, ())]
        return self.findings

    def _rule_isolation(self, tree, nodes):
        """TAL010: the port imports neither jax nor the reference, anywhere
        in a module; a module that declares itself 'Deliberately
        stdlib-only' imports only the standard library at module level."""
        for node in nodes:
            for mod in _imported(node):
                if mod.split(".")[0] in ("jax", "jaxlib", "tpu_als"):
                    self.add(node.lineno, "jaxfree-import",
                             f"imports {mod!r}: the port imports nothing "
                             "of JAX or of the reference package "
                             "(tests/test_torch_isolation.py pins the same "
                             "at run time)")
        if not _STDLIB_CLAIM_RE.search(self.text[:4000]):
            return
        stdlib = getattr(sys, "stdlib_module_names", ())
        for node in tree.body:
            for mod in _imported(node):
                top = mod.split(".")[0]
                if mod.startswith(".") or top not in stdlib:
                    self.add(node.lineno, "jaxfree-import",
                             f"module declares itself stdlib-only but "
                             f"imports {mod!r} at module level — any "
                             "tpu_als_torch module runs the package root, "
                             "which imports torch; import it inside the "
                             "function that needs it, or load a registry "
                             "standalone by file path")

    def _rule_magic_jitter(self, nodes, aliases):
        def is_magic(node):
            return isinstance(node, ast.Constant) \
                and node.value == 1e-6 and isinstance(node.value, float)

        def mentions_jitter(node):
            return (isinstance(node, ast.Name) and "jitter" in node.id) \
                or (isinstance(node, ast.Attribute)
                    and "jitter" in node.attr)

        msg = ("hardcoded 1e-6 jitter — use tpu_als_torch.ops.solve."
               "DEFAULT_JITTER (or thread AlsConfig.jitter) so the one "
               "regularization knob stays one knob")
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                pos_named = args.posonlyargs + args.args
                for a, d in zip(pos_named[len(pos_named)
                                          - len(args.defaults):],
                                args.defaults):
                    if a.arg == "jitter" and is_magic(d):
                        self.add(d.lineno, "magic-jitter", msg)
                for a, d in zip(args.kwonlyargs, args.kw_defaults):
                    if d is not None and a.arg == "jitter" \
                            and is_magic(d):
                        self.add(d.lineno, "magic-jitter", msg)
            elif isinstance(node, ast.keyword):
                if node.arg == "jitter" and is_magic(node.value):
                    self.add(node.value.lineno, "magic-jitter", msg)
            elif isinstance(node, ast.AnnAssign):
                # dataclass field: ``jitter: float = 1e-6``
                if isinstance(node.target, ast.Name) \
                        and "jitter" in node.target.id \
                        and node.value is not None \
                        and is_magic(node.value):
                    self.add(node.lineno, "magic-jitter", msg)
            elif isinstance(node, ast.Compare):
                sides = [node.left] + list(node.comparators)
                if any(is_magic(s) for s in sides) \
                        and any(mentions_jitter(s) for s in sides):
                    self.add(node.lineno, "magic-jitter", msg)
            elif isinstance(node, ast.BinOp) \
                    and isinstance(node.op, ast.Mult):
                for side, other in ((node.left, node.right),
                                    (node.right, node.left)):
                    if is_magic(side) and isinstance(other, ast.Call):
                        d = _dotted(other.func, aliases) or ""
                        if d.rsplit(".", 1)[-1] == "eye":
                            self.add(node.lineno, "magic-jitter", msg)

    def _rule_timer_brackets_span(self, nodes, aliases):
        """Every statement block of the module, each once."""
        for node in nodes:
            for field in ("body", "orelse", "finalbody"):
                block = getattr(node, field, None)
                if not isinstance(block, list):
                    continue
                for prev, nxt in zip(block, block[1:]):
                    if not (isinstance(prev, ast.Assign)
                            and isinstance(prev.value, ast.Call)):
                        continue
                    d = _dotted(prev.value.func, aliases) or ""
                    if not d.endswith(("perf_counter", "monotonic",
                                       "time.time")):
                        continue
                    if isinstance(nxt, ast.With) and any(
                            isinstance(item.context_expr, ast.Call)
                            and isinstance(item.context_expr.func,
                                           ast.Attribute)
                            and item.context_expr.func.attr == "span"
                            for item in nxt.items):
                        self.add(
                            prev.lineno, "timer-brackets-span",
                            "stage clock started before the obs.span "
                            "enter (and read after its exit) — the "
                            "span's own event emission lands in the "
                            "measured interval; move the perf_counter "
                            "read inside the span body")

    def _rule_explicit_rng(self, nodes, aliases):
        """TAL003's counterpart: every random draw names its generator."""
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            kw = {k.arg for k in node.keywords}
            d = _dotted(node.func, aliases) or ""
            if d in _GLOBAL_SEEDS:
                self.add(node.lineno, "wallclock-rng",
                         f"{d}() seeds the global RNG, which every other "
                         "draw shares — seed a torch.Generator and pass "
                         "it (generator=) instead")
            elif d in _RANDOM_CALLS and "generator" not in kw:
                self.add(node.lineno, "wallclock-rng",
                         f"{d}() without generator= draws from the "
                         "global RNG — pass a seeded torch.Generator, or "
                         "take the values (initial factors) from the "
                         "caller")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _RANDOM_METHODS \
                    and "generator" not in kw \
                    and not d.startswith(("numpy.", "random.")):
                self.add(node.lineno, "wallclock-rng",
                         f".{node.func.attr}() without generator= fills "
                         "from the global RNG — pass a seeded "
                         "torch.Generator")

    def _rule_dtype_drift(self, tree, functions, aliases):
        """TAL005's counterpart: no float16/bfloat16 cast and no TF32
        switch outside a dtype gate (a function that consults a
        ``.dtype``)."""
        for fn in [None] + functions:
            nodes = list(_walk_own(tree if fn is None else fn))
            if fn is not None and any(
                    isinstance(n, ast.Attribute) and n.attr == "dtype"
                    for n in nodes):
                continue                 # gated: the cast is informed
            where = f"in {fn.name!r}" if fn is not None else "at module level"
            for node in nodes:
                for line, what in self._low_precision(node, aliases):
                    self.add(line, "dtype-drift",
                             f"{what} {where} with no .dtype consultation "
                             "— the port computes in float32 unless the "
                             "caller's dtype asks otherwise; gate it on "
                             "the input's dtype (ops/solve.py solve_spd is "
                             "the idiom) and keep TF32 off "
                             "(utils/platform.py pin_fp32)")

    @staticmethod
    def _low_precision(node, aliases):
        def low(expr):
            d = _dotted(expr, aliases) or ""
            return d.startswith("torch.") and d.rsplit(".", 1)[-1] in _LOW

        if isinstance(node, ast.Call):
            f = node.func
            d = _dotted(f, aliases) or ""
            if isinstance(f, ast.Attribute) and f.attr in ("half",
                                                           "bfloat16") \
                    and not node.args and not d.startswith("torch."):
                yield node.lineno, f"unconditional .{f.attr}() cast"
            if isinstance(f, ast.Attribute) and f.attr in ("to", "type") \
                    and node.args and low(node.args[0]):
                yield node.lineno, f"unconditional .{f.attr}(" \
                    f"{_dotted(node.args[0], aliases)}) cast"
            for k in node.keywords:
                if k.arg == "dtype" and low(k.value):
                    yield node.lineno, f"dtype={_dotted(k.value, aliases)}"
            if d.endswith("set_float32_matmul_precision") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and node.args[0].value in ("high", "medium"):
                yield node.lineno, (f"set_float32_matmul_precision("
                                    f"{node.args[0].value!r}) (TF32)")
        elif isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Constant) \
                and node.value.value is True:
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "allow_tf32":
                    yield node.lineno, "allow_tf32 = True"


# -- front end ---------------------------------------------------------

def _load_vocab():
    spec = importlib.util.spec_from_file_location(
        "_tal_torch_vocab", os.path.join(HERE, "vocab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_baseline(path):
    keys = set()
    if path and os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    keys.add(line)
    return keys


def lint_paths(paths, repo=REPO, with_vocab=True):
    """Lint files/dirs; returns (findings, nfiles)."""
    vocab = _load_vocab() if with_vocab else None
    findings, nfiles = [], 0
    for path in _py_files(paths):
        nfiles += 1
        findings.extend(FileLinter(path, repo, vocab).run())
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, nfiles


def _py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs.sort()
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def print_rules():
    for slug, (tal, help_) in RULES.items():
        if slug in NOT_CARRIED:
            print(f"{tal}  {slug:22s} not carried: {NOT_CARRIED[slug]}")
        else:
            print(f"{tal}  {slug:22s} {help_}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="tpu_als_torch lint",
        description="the port's linter and contract verifier "
                    "(stdlib-only; --contracts needs torch)")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="files/dirs to lint (default: tpu_als_torch/ and "
                         "chip_smoke.py)")
    ap.add_argument("--baseline", default=BASELINE_DEFAULT,
                    help="baseline file of accepted findings (default: "
                         "tpu_als_torch/analysis/lint_baseline.txt; "
                         "'none' disables)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline file "
                         "and exit 0")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--contracts", action="store_true",
                    help="also verify the contract registry (imports "
                         "torch; on --device)")
    ap.add_argument("--contract", action="append", default=None,
                    help="verify only this named contract (repeatable; "
                         "implies --contracts)")
    ap.add_argument("--device", default=None,
                    help="torch device for the contracts (default: cuda; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.rules:
        print_rules()
        return 0

    t0 = time.perf_counter()
    default_run = args.paths is None
    paths = args.paths if args.paths \
        else [os.path.join(REPO, p) for p in DEFAULT_ROOTS]
    findings, nfiles = lint_paths(paths)

    if default_run:
        # the cross-module vocabulary contracts: only meaningful over the
        # default roots
        vocab = _load_vocab()
        for check in (vocab.check_plan_vocabulary,
                      vocab.check_tenant_vocabulary,
                      vocab.check_trace_vocabulary,
                      vocab.check_elastic_vocabulary,
                      vocab.check_soak_vocabulary):
            for msg in check(REPO):
                path, _, rest = msg.partition(": ")
                findings.append(Finding(path, 1, "unregistered-name", rest))

    baseline_path = None if args.baseline == "none" else args.baseline
    if args.write_baseline:
        with open(baseline_path or BASELINE_DEFAULT, "w",
                  encoding="utf-8") as f:
            f.write("# tpu_als_torch lint baseline — accepted findings, "
                    "one 'path :: rule :: message' per line.\n"
                    "# Policy: keep this EMPTY.  Fix findings or "
                    "suppress at the site with a reason\n"
                    "# ('# tal: disable=<rule> -- <why>').\n")
            for fd in findings:
                f.write(fd.key + "\n")
        print(f"tpu_als_torch lint: wrote {len(findings)} finding(s) to "
              f"{baseline_path or BASELINE_DEFAULT}")
        return 0

    baseline = load_baseline(baseline_path)
    new = [f for f in findings if f.key not in baseline]
    matched = {f.key for f in findings if f.key in baseline}
    for entry in sorted(baseline - matched):
        print(f"tpu_als_torch lint: note: stale baseline entry (fixed? "
              f"remove it): {entry}", file=sys.stderr)

    rc = 0
    if new:
        for f in new:
            print(f.render(), file=sys.stderr)
        print(f"tpu_als_torch lint: {len(new)} finding(s) in {nfiles} "
              "files", file=sys.stderr)
        rc = 1
    else:
        dt = time.perf_counter() - t0
        print(f"tpu_als_torch lint: OK ({nfiles} files, "
              f"{len(matched)} baselined, {dt:.2f}s)")

    if args.contracts or args.contract:
        rc = max(rc, _run_contracts(args.contract, args.device))
    return rc


def _run_contracts(only=None, device=None):
    """Verify the contract registry on ``device`` (the torch doorway)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tpu_als_torch.analysis import contracts

    known = set(contracts.names())
    bad = 0
    for n in only or ():
        if n in contracts.REFUSED:
            print(f"contract {n}: REFUSED — {contracts.REFUSED[n]}",
                  file=sys.stderr)
            bad += 1
        elif n not in known:
            print(f"contract {n}: UNKNOWN (not registered)",
                  file=sys.stderr)
            bad += 1
    results = contracts.verify_all(only=only, device=device)
    for r in results:
        status = "OK" if r.ok else "FAIL"
        print(f"contract {r.name}: {status} — {r.detail}")
        if not r.ok:
            bad += 1
    if bad:
        print(f"tpu_als_torch lint --contracts: {bad} contract(s) failed",
              file=sys.stderr)
        return 1
    print(f"tpu_als_torch lint --contracts: OK ({len(results)} verified)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
