"""Lock-discipline AST lint: the port's copy of ``repro/analysis/
lock_lint.py``.

The async layers (``train/planner.PlanPipeline``, ``serve/service``'s
``WeightStore`` / ``AsyncTreeRLService``, and the compile warm-up's
``serve/session.GraphPool``, ``train/warmup.AOTWarmupService`` and
``train/exec_cache.ExecutableCache``, whose rules the port adds) are
exactly the code a refactor
breaks silently: an unlocked write to shared queue state races the
consumer and shows up as a once-a-week hang, not a test failure.  This
pass pins the lock→fields discipline as data (:data:`LOCK_RULES`) and
proves by AST walk that every mutation of a guarded attribute happens
under a ``with self.<lock>:`` block.

What counts as a mutation of ``self.f``:

  * ``self.f = ...`` / ``self.f += ...``      (Assign / AugAssign)
  * ``self.f, self.g = ...``                  (each name of a tuple or
                                               list target; the
                                               reference's walk skips
                                               such targets)
  * ``self.f[k] = ...`` / ``del self.f[k]``   (Subscript store/delete)
  * ``self.f.append(...)`` and friends        (known mutator methods)

``__init__`` is exempt (no concurrent reader exists before construction
returns).  Fields in a rule's ``exempt`` map are skipped with their
documented reason — e.g. single-writer stats counters, or fields whose
happens-before edge is a ``Queue`` put/get rather than a lock.

The lint is class-scoped: the port's module-level locks
(``serve/session.CAPTURE_LOCK``, ``kernels/build.BUILD_LOCK`` and
``_LOAD_LOCK``) guard no class field and lie outside its reach.

Pure stdlib AST code.  ``check_source`` takes raw source text so a test
can seed an unlocked write and watch it get caught.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field as dc_field

MUTATORS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popleft", "clear",
    "add", "discard", "update", "setdefault", "put", "put_nowait",
    "sort", "reverse",
})


@dataclass(frozen=True)
class LockRule:
    """lock: attribute name of the owning lock/condition (None = the
    class is lock-free by design and documents that via ``exempt``)."""
    lock: str | None
    fields: frozenset[str]
    exempt: dict[str, str] = dc_field(default_factory=dict)


# file (relative to src/repro_torch) → class → rule.  THE declared
# discipline.
LOCK_RULES: dict[str, dict[str, LockRule]] = {
    "train/planner.py": {
        "PlanPipeline": LockRule(
            lock="_cv",
            fields=frozenset({"_results", "_next_pull", "_next_out",
                              "_exhausted", "_stop"}),
            exempt={
                "schedule_s": "stats counter: written under _cv on the "
                              "worker path, unlocked only on the "
                              "workers=0 synchronous path (one thread)",
                "build_s": "same as schedule_s",
                "exposed_s": "same as schedule_s",
                "built": "same as schedule_s",
            }),
    },
    "serve/session.py": {
        "GraphPool": LockRule(
            lock="_lock", fields=frozenset({"_graphs", "captures",
                                            "reuses"})),
    },
    "train/warmup.py": {
        "AOTWarmupService": LockRule(
            lock="_lock", fields=frozenset({"errors", "prewarmed",
                                            "background_s"})),
    },
    "train/exec_cache.py": {
        "ExecutableCache": LockRule(
            lock="_lock", fields=frozenset({"_store", "hits", "misses",
                                            "inserts", "compile_s"})),
    },
    "serve/service.py": {
        "WeightStore": LockRule(
            lock="_cond",
            fields=frozenset({"_params", "_version", "_ready"})),
        "AsyncTreeRLService": LockRule(
            lock=None,
            fields=frozenset(),
            exempt={
                "_error": "written only by the producer thread before it "
                          "enqueues the None sentinel; Queue.put/get is "
                          "the happens-before edge the consumer reads "
                          "through",
                "stats": "single-writer-per-field counters: the gen "
                         "thread owns the generation counters, the "
                         "consumer owns exposed_wait_s",
            }),
    },
}


class _LockVisitor(ast.NodeVisitor):
    """Walks one class body tracking the ``with self.<lock>:`` nesting."""

    def __init__(self, rule: LockRule, cls: str):
        self.rule, self.cls = rule, cls
        self.lock_depth = 0
        self.method: str | None = None
        self.findings: list[str] = []

    # -- scoping -----------------------------------------------------------
    def _visit_method(self, node):
        prev, self.method = self.method, node.name
        prev_d, self.lock_depth = self.lock_depth, 0
        self.generic_visit(node)
        self.method, self.lock_depth = prev, prev_d

    visit_FunctionDef = visit_AsyncFunctionDef = _visit_method

    def _holds_lock(self, item_expr) -> bool:
        return (self.rule.lock is not None
                and isinstance(item_expr, ast.Attribute)
                and item_expr.attr == self.rule.lock
                and isinstance(item_expr.value, ast.Name)
                and item_expr.value.id == "self")

    def visit_With(self, node):
        locked = any(self._holds_lock(i.context_expr) for i in node.items)
        self.lock_depth += 1 if locked else 0
        self.generic_visit(node)
        self.lock_depth -= 1 if locked else 0

    # -- mutation detection ------------------------------------------------
    def _targets(self, target) -> list:
        """A store target's parts: each element of a tuple or list
        target (``self.a, self.b = ...``), recursively."""
        if isinstance(target, (ast.Tuple, ast.List)):
            return [t for e in target.elts for t in self._targets(e)]
        if isinstance(target, ast.Starred):
            return self._targets(target.value)
        return [target]

    def _guarded_field(self, expr) -> str | None:
        """self.f → f when f is a guarded field (unwraps self.f[k])."""
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and expr.attr in self.rule.fields):
            return expr.attr
        return None

    def _flag(self, f: str, lineno: int) -> None:
        if self.method == "__init__":
            return
        if self.lock_depth == 0:
            self.findings.append(
                f"{self.cls}.{self.method or '<class>'} line {lineno}: "
                f"mutation of self.{f} outside 'with self."
                f"{self.rule.lock}:' — declared lock discipline "
                f"(analysis/lock_lint.LOCK_RULES) requires the owning "
                f"lock for every write")

    def visit_Assign(self, node):
        for t in (p for tgt in node.targets for p in self._targets(tgt)):
            f = self._guarded_field(t)
            if f:
                self._flag(f, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        f = self._guarded_field(node.target)
        if f:
            self._flag(f, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node):
        for t in node.targets:
            f = self._guarded_field(t)
            if f:
                self._flag(f, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node):
        fn = node.func
        if (isinstance(fn, ast.Attribute) and fn.attr in MUTATORS):
            f = self._guarded_field(fn.value)
            if f:
                self._flag(f, node.lineno)
        self.generic_visit(node)


def check_source(source: str, rules: dict[str, LockRule],
                 filename: str = "<source>") -> list[str]:
    """Lint one file's source against {class_name: LockRule}."""
    tree = ast.parse(source)
    findings: list[str] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name in rules:
            v = _LockVisitor(rules[node.name], node.name)
            for stmt in node.body:
                v.visit(stmt)
            findings += [f"{filename}: {m}" for m in v.findings]
    return findings


def lock_findings(src_root: str | None = None) -> list[str]:
    """Run the declared LOCK_RULES over the real sources."""
    if src_root is None:
        src_root = os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))
    out: list[str] = []
    for rel, rules in sorted(LOCK_RULES.items()):
        path = os.path.join(src_root, rel)
        with open(path) as fh:
            out += check_source(fh.read(), rules, filename=rel)
    return out
