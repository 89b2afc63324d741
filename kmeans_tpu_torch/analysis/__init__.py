"""Static invariant linter for the kmeans_tpu_torch package.

Counterpart of ``kmeans_tpu/analysis/``: the same 17 rule ids, each a
machine-checked version of an invariant that a review pass of the
original project had to enforce at least once — compile-cache keys
missing a knob that changes the built program, dead private helpers
silently bypassed by every call site, audit counters stale across fits,
the thread/close discipline of the prefetch producer and the serving
queue.  The rules that read plain Python shared by both packages carry
over as they are; the rest match the port's torch idioms (CUDA-graph
captured bodies for ``trace-hazard``, ``Dataset.memo`` and
``ServingEngine._fn`` for ``cache-key``, ``.to(device)`` placements for
``ingest-span`` ...; README's port section lists them).  The analysis is
pure stdlib ``ast`` + ``tokenize``: it never imports or executes the
modules it CHECKS, so linting creates no CUDA context, runs no ``nvcc``
and loads no kernel library.

Public surface:

* :func:`lint_paths` — run every rule over a set of files/directories,
  returning a :class:`Report` (findings + suppression inventory).
* :data:`RULES` — the rule registry (id -> rule instance).
* ``python -m kmeans_tpu_torch lint [--json] [paths]`` — the CLI
  (:mod:`kmeans_tpu_torch.analysis.cli`, re-exported as
  ``kmeans_tpu_torch.cli.lint_main``); exit 2 on findings.

Suppression grammar (explicit and counted, never silent)::

    some_flagged_line()   # lint: ok(rule-id) — short reason

The comment must name the rule id and carry a non-empty reason after
an em-dash or hyphen; it applies to its own line or, when written on
its own line, to the next code line.  Malformed suppressions are
themselves findings (rule ``suppression``), and the full suppression
inventory is part of the ``--json`` report so count regressions are
reviewable.
"""

from kmeans_tpu_torch.analysis.core import (Finding, Module, Package,
                                            Report, Suppression,
                                            load_package, lint_paths)
from kmeans_tpu_torch.analysis.rules import RULES

__all__ = ["Finding", "Module", "Package", "Report", "Suppression",
           "load_package", "lint_paths", "RULES"]
