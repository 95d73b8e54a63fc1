"""AST lint rules enforcing the simulator's determinism contract.

Each rule is a callable ``(tree, source) -> [(line, rule_name, message)]``
registered in ``RULES``. The rules are deliberately *lexical*: they reason
about one module at a time with no imports resolved and no type inference
beyond local assignment tracking. That keeps them fast, dependency-free and
predictable — a finding always points at the exact expression that needs a
``sorted(...)`` wrap, a named ``RngStream``, or a justified
``# simlint: ok(<rule>)`` suppression (see docs/determinism.md).

Rule summary:

* ``builtin-hash``      — builtin ``hash()`` is salted per process
                          (PYTHONHASHSEED); use ``simcore.stable_hash``.
* ``wall-clock``        — ``time.time``/``perf_counter``/``datetime.now``
                          never feed simulated state; sim time is ``env.now``.
* ``global-rng``        — draws on the process-global ``random`` /
                          ``np.random`` state bypass named ``RngStream``s.
* ``set-iteration``     — iterating a ``set`` observes hash order (salted
                          for str, insertion-history-dependent for int)
                          unless wrapped in ``sorted(...)``.
* ``dict-iteration``    — ``.keys()/.values()/.items()`` iteration inside
                          order-sensitive functions (place/steal/rebalance/
                          split/merge/migrate/recover/pick/victim) must be
                          ``sorted(...)`` or justified as insertion-
                          deterministic via a suppression.
* ``lock-order``        — consecutive ``yield <x>.<lock>.acquire()`` in one
                          function must derive from an id-``sorted``
                          sequence (the quiesce discipline of
                          ``_migrate_functions``/``_split_function``).
* ``held-lock-timeout`` — ``yield env.timeout(...)`` while a ``*lock*``
                          resource is held is a modeled hold window and must
                          be annotated with a suppression that justifies it.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

RawFinding = Tuple[int, str, str]

# -- shared helpers -----------------------------------------------------------

_WALL_CLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "datetime.now", "datetime.utcnow", "datetime.today", "date.today",
}

# construction/inspection of RNG machinery is fine; *draws* and global
# seeding are not
_NP_RANDOM_OK = {
    "default_rng", "SeedSequence", "Generator", "RandomState",
    "BitGenerator", "PCG64", "Philox", "MT19937", "get_state",
}
_PY_RANDOM_OK = {"Random", "SystemRandom", "getstate"}

# callables whose result does not depend on argument iteration order
# (``sorted``/``min``/``max`` only without ``key=``: ties under a key
# function are resolved by input order)
_ORDER_INSENSITIVE = {"sorted", "len", "any", "all", "set", "frozenset",
                      "min", "max"}
_ITERATING_SINKS = {"list", "tuple", "iter", "enumerate", "reversed"}

_ORDER_SENSITIVE_FN = re.compile(
    r"place|steal|rebalance|pick|victim|split|merge|migrat|recover")

_LOCKISH = re.compile(r"lock", re.IGNORECASE)


def _dotted(node: ast.AST) -> Optional[str]:
    """Best-effort dotted repr of an expression: ``self.env.timeout`` →
    ``"self.env.timeout"``, subscripts become ``[]``, calls ``()``."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    if isinstance(node, ast.Subscript):
        base = _dotted(node.value)
        return f"{base}[]" if base else None
    if isinstance(node, ast.Call):
        base = _dotted(node.func)
        return f"{base}()" if base else None
    return None


def _call_name(node: ast.Call) -> Optional[str]:
    return _dotted(node.func)


def _annotate_parents(tree: ast.AST) -> None:
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._simlint_parent = parent  # type: ignore[attr-defined]


def _parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_simlint_parent", None)


def _is_sorted_call(node: ast.AST) -> bool:
    """``sorted(...)`` with no ``key=`` (ties under a key keep input order)."""
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "sorted"
            and not any(kw.arg == "key" for kw in node.keywords))


# -- rule: builtin-hash -------------------------------------------------------

def rule_builtin_hash(tree: ast.AST, source: str) -> List[RawFinding]:
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "hash"):
            out.append((node.lineno, "builtin-hash",
                        "builtin hash() is salted per process "
                        "(PYTHONHASHSEED) and must never feed simulation "
                        "state — use simcore.stable_hash"))
    return out


# -- rule: wall-clock ---------------------------------------------------------

def rule_wall_clock(tree: ast.AST, source: str) -> List[RawFinding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name is None:
            continue
        if name in _WALL_CLOCK or any(name.endswith("." + w)
                                      for w in _WALL_CLOCK):
            out.append((node.lineno, "wall-clock",
                        f"wall-clock call {name}() — simulated state must "
                        f"only observe env.now"))
    return out


# -- rule: global-rng ---------------------------------------------------------

def rule_global_rng(tree: ast.AST, source: str) -> List[RawFinding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name is None or "." not in name:
            continue
        parts = name.split(".")
        if parts[0] == "random" and len(parts) >= 2 \
                and parts[1] not in _PY_RANDOM_OK:
            out.append((node.lineno, "global-rng",
                        f"{name}() uses the process-global random state — "
                        f"draw through a named env.rng(<stream>) instead"))
        elif len(parts) >= 3 and parts[0] in ("np", "numpy") \
                and parts[1] == "random" and parts[2] not in _NP_RANDOM_OK:
            out.append((node.lineno, "global-rng",
                        f"{name}() draws from numpy's global RNG — draw "
                        f"through a named env.rng(<stream>) instead"))
    return out


# -- rule: set-iteration / dict-iteration -------------------------------------

class _SetFacts(ast.NodeVisitor):
    """Collect names statically known to hold sets.

    Attribute names are pooled module-wide (``self.pending`` in one class
    taints ``x.pending`` everywhere — deliberate conservatism); bare names
    are collected per enclosing function by the caller.
    """

    def __init__(self) -> None:
        self.names: Set[str] = set()
        self.attrs: Set[str] = set()

    @staticmethod
    def _set_annotation(ann: Optional[ast.AST]) -> bool:
        if ann is None:
            return False
        base = ann.value if isinstance(ann, ast.Subscript) else ann
        name = _dotted(base)
        if name is None and isinstance(base, ast.Constant):
            name = str(base.value)
        return name is not None and name.split(".")[-1] in (
            "set", "Set", "frozenset", "FrozenSet", "MutableSet", "AbstractSet")

    @staticmethod
    def _set_value(value: Optional[ast.AST]) -> bool:
        if value is None:
            return False
        if isinstance(value, (ast.Set, ast.SetComp)):
            return True
        if isinstance(value, ast.Call):
            name = _call_name(value)
            if name in ("set", "frozenset"):
                return True
            # dataclasses: field(default_factory=set)
            if name == "field":
                for kw in value.keywords:
                    if kw.arg == "default_factory" and \
                            isinstance(kw.value, ast.Name) and \
                            kw.value.id in ("set", "frozenset"):
                        return True
        return False

    def _record(self, target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.names.add(target.id)
        elif isinstance(target, ast.Attribute):
            self.attrs.add(target.attr)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        # class-level declarations (dataclass fields) are attribute facts:
        # ``sandbox_ids: set = field(default_factory=set)`` taints
        # ``<x>.sandbox_ids`` everywhere in the module
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name) and \
                    (self._set_annotation(stmt.annotation)
                     or self._set_value(stmt.value)):
                self.attrs.add(stmt.target.id)
            elif isinstance(stmt, ast.Assign) and self._set_value(stmt.value):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        self.attrs.add(t.id)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if self._set_annotation(node.annotation) or self._set_value(node.value):
            self._record(node.target)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._set_value(node.value):
            for t in node.targets:
                self._record(t)
        self.generic_visit(node)

    def visit_arg(self, node: ast.arg) -> None:
        if self._set_annotation(node.annotation):
            self.names.add(node.arg)
        self.generic_visit(node)


def _module_set_attrs(tree: ast.AST) -> Set[str]:
    facts = _SetFacts()
    facts.visit(tree)
    return facts.attrs


def _function_set_names(fn: ast.AST) -> Set[str]:
    facts = _SetFacts()
    facts.visit(fn)
    return facts.names


def _is_set_expr(node: ast.AST, names: Set[str], attrs: Set[str]) -> bool:
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Attribute):
        return node.attr in attrs
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = _call_name(node)
        if name in ("set", "frozenset"):
            return True
        if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "union", "intersection", "difference",
                "symmetric_difference", "copy"):
            return _is_set_expr(node.func.value, names, attrs)
        return False
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.BitXor, ast.Sub)):
        return (_is_set_expr(node.left, names, attrs)
                or _is_set_expr(node.right, names, attrs))
    return False


def _comp_sink_ok(comp: ast.AST) -> bool:
    """A comprehension/genexp feeding an order-insensitive callable (or a
    constant-element ``sum``) is exempt: the iteration order cannot leak."""
    parent = _parent(comp)
    if not (isinstance(parent, ast.Call) and isinstance(parent.func, ast.Name)):
        return False
    fname = parent.func.id
    if fname in ("sorted", "min", "max"):
        return not any(kw.arg == "key" for kw in parent.keywords)
    if fname in _ORDER_INSENSITIVE:
        return True
    if fname == "sum" and isinstance(comp, (ast.GeneratorExp, ast.ListComp)):
        return isinstance(comp.elt, ast.Constant)
    return False


def _iteration_findings(fn: ast.AST, names: Set[str], attrs: Set[str],
                        order_sensitive: bool) -> List[RawFinding]:
    out: List[RawFinding] = []

    def check_iter(it: ast.AST, where: str, sink_ok: bool) -> None:
        if _is_sorted_call(it):
            return
        if _is_set_expr(it, names, attrs):
            if sink_ok:
                return
            out.append((it.lineno, "set-iteration",
                        f"{where} iterates a set ({_dotted(it) or 'set expr'})"
                        f" in hash order — wrap in sorted(...)"))
        elif order_sensitive and isinstance(it, ast.Call) and \
                isinstance(it.func, ast.Attribute) and \
                it.func.attr in ("keys", "values", "items") and not it.args:
            if sink_ok:
                return
            out.append((it.lineno, "dict-iteration",
                        f"{where} iterates {_dotted(it)} on an order-"
                        f"sensitive path — wrap in sorted(...) or suppress "
                        f"with a note proving insertion order is "
                        f"deterministic"))

    for node in ast.walk(fn):
        if isinstance(node, ast.For):
            check_iter(node.iter, "for-loop", sink_ok=False)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                               ast.DictComp)):
            sink_ok = _comp_sink_ok(node)
            for gen in node.generators:
                check_iter(gen.iter, "comprehension", sink_ok=sink_ok)
        elif isinstance(node, ast.Call):
            fname = _call_name(node)
            if fname in _ITERATING_SINKS and node.args:
                check_iter(node.args[0], f"{fname}()", sink_ok=False)
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "join" and node.args:
                check_iter(node.args[0], "str.join()", sink_ok=False)
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "pop" and not node.args and \
                    _is_set_expr(node.func.value, names, attrs):
                out.append((node.lineno, "set-iteration",
                            f"{_dotted(node.func.value)}.pop() returns an "
                            f"arbitrary (hash-order) element — pop from a "
                            f"sorted sequence instead"))
    return out


def rule_container_iteration(tree: ast.AST, source: str) -> List[RawFinding]:
    attrs = _module_set_attrs(tree)
    out: List[RawFinding] = []
    seen_fn_lines: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            seen_fn_lines.add(node.lineno)
            names = _function_set_names(node)
            sensitive = bool(_ORDER_SENSITIVE_FN.search(node.name))
            out.extend(_iteration_findings(node, names, attrs, sensitive))
    # dedup: nested functions are walked twice (outer + inner visit)
    uniq = sorted(set(out))
    return uniq


# -- rule: lock-order / held-lock-timeout -------------------------------------

def _lockish_acquire(call: ast.Call) -> Optional[str]:
    """Dotted base of ``<base>.acquire()`` when <base> smells like a lock."""
    if isinstance(call.func, ast.Attribute) and call.func.attr == "acquire":
        base = _dotted(call.func.value)
        if base and _LOCKISH.search(base):
            return base
    return None


def _lockish_release(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Attribute) and call.func.attr == "release":
        base = _dotted(call.func.value)
        if base and _LOCKISH.search(base):
            return base
    return None


def _is_env_timeout(call: ast.Call) -> bool:
    name = _call_name(call)
    if not name:
        return False
    parts = name.split(".")
    return parts[-1] in ("timeout", "timeout_at") and (
        len(parts) >= 2 and parts[-2] == "env" or parts[0] == "env")


def _yielded_call(stmt: ast.stmt) -> Optional[ast.Call]:
    """The Call inside ``yield <call>`` as an expression statement or the
    RHS of an assignment (``x = yield <call>``)."""
    value = None
    if isinstance(stmt, ast.Expr):
        value = stmt.value
    elif isinstance(stmt, ast.Assign):
        value = stmt.value
    if isinstance(value, (ast.Yield, ast.YieldFrom)) and \
            isinstance(value.value, ast.Call):
        return value.value
    return None


class _OrderedNames:
    """Names provably derived from a ``sorted(...)`` sequence inside one
    function — the id-sorted quiesce discipline's dataflow. Unlike the
    set-iteration exemption, ``sorted`` with a ``key=`` counts: lock bases
    are sorted by unique ids, so keyed sorts impose the same global order
    on every process."""

    def __init__(self, fn: ast.AST) -> None:
        self.names: Set[str] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            if self._ordered_value(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.names.add(t.id)
                    elif isinstance(t, ast.Tuple):
                        for elt in t.elts:
                            if isinstance(elt, ast.Name):
                                self.names.add(elt.id)

    @staticmethod
    def _any_sorted_call(node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "sorted")

    def _ordered_value(self, value: ast.AST) -> bool:
        if self._any_sorted_call(value):
            return True
        if isinstance(value, ast.Name) and value.id in self.names:
            return True
        if isinstance(value, (ast.ListComp, ast.GeneratorExp)) and \
                len(value.generators) == 1:
            return self.iter_ordered(value.generators[0].iter)
        if isinstance(value, ast.Call) and _call_name(value) in (
                "list", "tuple") and value.args:
            return self.iter_ordered(value.args[0])
        return False

    def iter_ordered(self, it: ast.AST) -> bool:
        if self._any_sorted_call(it):
            return True
        return isinstance(it, ast.Name) and it.id in self.names


class _LockScanner:
    """Lexical abstract interpretation of lock holds in one function body.

    Tracks the set of held lock bases through straight-line code, branches
    (union), loops (entry ∪ body-exit ∪ state-at-each-break) and
    try/finally. Emits ``lock-order`` when a second lock is requested while
    one is held and either base does not trace to an id-``sorted`` sequence,
    and ``held-lock-timeout`` for every ``yield env.timeout(...)`` reached
    with a non-empty held set.
    """

    def __init__(self, fn: ast.AST) -> None:
        self.fn = fn
        self.ordered = _OrderedNames(fn)
        self.findings: List[RawFinding] = []
        # loop targets whose iterable was ordered: acquires rooted at these
        # names are part of a sanctioned sorted sweep
        self._ordered_loop_roots: Set[str] = set()

    def run(self) -> List[RawFinding]:
        self._scan(self.fn.body, {}, [])
        return self.findings

    # held: dict base -> first acquire line; breaks: list of held snapshots
    def _scan(self, stmts, held: Dict[str, int], breaks) -> Dict[str, int]:
        for stmt in stmts:
            held = self._scan_stmt(stmt, held, breaks)
        return held

    def _root_ordered(self, base: str) -> bool:
        root = base.split(".")[0].split("[")[0]
        return root in self.ordered.names or root in self._ordered_loop_roots

    def _on_acquire(self, base: str, line: int, held: Dict[str, int]) -> None:
        if base in held:
            self.findings.append((line, "lock-order",
                                  f"re-acquire of held lock {base} "
                                  f"(first acquired at line {held[base]}) "
                                  f"would self-deadlock"))
            return
        if held:
            bad = [b for b in [*held, base] if not self._root_ordered(b)]
            if bad:
                self.findings.append(
                    (line, "lock-order",
                     f"acquiring {base} while holding "
                     f"{sorted(held)} — multi-lock acquires must derive "
                     f"from an id-sorted sequence (unsorted: {sorted(bad)})"))
        held[base] = line

    def _scan_stmt(self, stmt, held, breaks) -> Dict[str, int]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return held          # nested defs run later, scanned separately
        if isinstance(stmt, ast.Break):
            breaks.append(dict(held))
            return held
        call = _yielded_call(stmt)
        if call is not None:
            base = _lockish_acquire(call)
            if base is not None:
                self._on_acquire(base, call.lineno, held)
                return held
            if _is_env_timeout(call) and held:
                locks = ", ".join(sorted(held))
                self.findings.append(
                    (call.lineno, "held-lock-timeout",
                     f"yield env.timeout(...) while holding {locks} — "
                     f"annotate the modeled hold window with "
                     f"`# simlint: ok(held-lock-timeout): <why>`"))
                return held
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            base = _lockish_release(stmt.value)
            if base is not None:
                held.pop(base, None)
                return held
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return self._scan_loop(stmt, held, breaks)
        if isinstance(stmt, ast.While):
            return self._scan_loop(stmt, held, breaks)
        if isinstance(stmt, ast.If):
            a = self._scan(stmt.body, dict(held), breaks)
            b = self._scan(stmt.orelse, dict(held), breaks)
            return {**a, **b}
        if isinstance(stmt, ast.Try):
            body = self._scan(stmt.body, dict(held), breaks)
            merged = {**held, **body}
            for handler in stmt.handlers:
                merged.update(self._scan(handler.body, dict(merged), breaks))
            merged.update(self._scan(stmt.orelse, dict(body), breaks))
            return self._scan(stmt.finalbody, merged, breaks)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._scan(stmt.body, held, breaks)
        return held

    def _scan_loop(self, stmt, held, breaks) -> Dict[str, int]:
        target = stmt.target.id if isinstance(stmt, (ast.For, ast.AsyncFor)) \
            and isinstance(stmt.target, ast.Name) else None
        iter_ordered = isinstance(stmt, (ast.For, ast.AsyncFor)) and \
            self.ordered.iter_ordered(stmt.iter)
        if target is not None and iter_ordered:
            self._ordered_loop_roots.add(target)

        # a loop that acquires on its own target and releases nothing inside
        # is a multi-lock sweep: the iterable itself must be id-sorted
        if target is not None and not iter_ordered:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    base = _lockish_acquire(node)
                    if base and base.split(".")[0] == target:
                        self.findings.append(
                            (node.lineno, "lock-order",
                             f"lock sweep acquires {base} while looping "
                             f"over an iterable not provably sorted — "
                             f"iterate a sorted(...) sequence"))
                        break

        loop_breaks: List[Dict[str, int]] = []
        body_exit = self._scan(stmt.body, dict(held), loop_breaks)
        orelse_exit = self._scan(stmt.orelse, dict(body_exit), loop_breaks)
        out = dict(held)
        out.update(body_exit)
        out.update(orelse_exit)
        for snap in loop_breaks:
            out.update(snap)
        return out


def rule_locks(tree: ast.AST, source: str) -> List[RawFinding]:
    out: List[RawFinding] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.extend(_LockScanner(node).run())
    return sorted(set(out))


# -- registry -----------------------------------------------------------------

RULES = {
    "builtin-hash": rule_builtin_hash,
    "wall-clock": rule_wall_clock,
    "global-rng": rule_global_rng,
    "set-iteration": rule_container_iteration,   # also emits dict-iteration
    "lock-order": rule_locks,                    # also emits held-lock-timeout
}

# every rule name a finding (or suppression) may carry
RULE_NAMES = ("builtin-hash", "wall-clock", "global-rng", "set-iteration",
              "dict-iteration", "lock-order", "held-lock-timeout",
              "stale-suppression")


def all_raw_findings(tree: ast.AST, source: str) -> List[RawFinding]:
    _annotate_parents(tree)
    out: List[RawFinding] = []
    for rule in RULES.values():
        out.extend(rule(tree, source))
    return sorted(set(out))
