"""Static analysis of the port: the linter, the literal-vocabulary engine
and the contract registry.

Counterpart of ``tpu_als/analysis/``.  Three modules, layered by what
they may import:

- :mod:`tpu_als_torch.analysis.lint`: the AST linter
  (``python -m tpu_als_torch.cli lint``).  Deliberately stdlib-only and
  runnable as a file (``python tpu_als_torch/analysis/lint.py``) with
  neither torch nor jax importable.
- :mod:`tpu_als_torch.analysis.vocab`: the obs and fault literal
  vocabulary behind the linter's ``unregistered-name`` rule
  (``python tpu_als_torch/analysis/vocab.py``).  Also stdlib-only: it
  loads ``tpu_als_torch/obs/schema.py`` and
  ``tpu_als_torch/resilience/faults.py`` by file path, never through the
  package root, which imports torch.
- :mod:`tpu_als_torch.analysis.contracts`: the ``Contract(name, build,
  pin)`` registry of the port's byte and signature pins; torch loads
  inside each ``build``.

This ``__init__`` resolves the three lazily, so it adds no import of its
own to the package's.
"""

from __future__ import annotations

_SUBMODULES = ("contracts", "lint", "vocab")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
