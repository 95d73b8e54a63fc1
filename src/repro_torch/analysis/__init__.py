"""Static determinism analysis for the DES control plane (``simlint``).

The simulator's headline property — bit-identical replay from a seed,
pinned by exact event budgets and goldens — survives only as long as no
code path consults process-varying state (builtin ``hash``, wall clocks,
the global RNG) or iterates hash-ordered containers on a scheduling path.
This package holds the AST-visitor rules behind ``tools/simlint.py``; the
rule catalog with rationale lives in ``docs/determinism.md``.
"""
from .lint import (DEFAULT_PATHS, Finding, lint_file, lint_paths,
                   lint_source, main)
from .rules import RULES

__all__ = ["DEFAULT_PATHS", "Finding", "RULES", "lint_file", "lint_paths",
           "lint_source", "main"]
