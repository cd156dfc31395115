"""AST pass for lock discipline in threaded classes (codes CC301-CC302).

Port of ``repro.analysis.concurrency``, kept as its own copy (the port
imports nothing of ``repro``); the two give identical findings.

Per class, the pass finds lock attributes (``self.x = threading.Lock() /
RLock() / Condition()``), then builds an attribute access map: every
``self.<attr>`` read, write (assignment, augmented/subscript assignment,
or a mutating method call like ``.append()`` / ``.popleft()``), the
method and line it happens in, and whether a ``with self.<lock>:`` block
is lexically held there.  ``__init__`` is construction — the instance
isn't shared yet — so it's excluded from the map.

Flagged:

* **CC301** — an attribute with at least one *locked write* that is also
  accessed without the lock, or (the inverse hazard) unlocked *writes*
  to an attribute other methods access under the lock.  Either every
  cross-thread access takes the lock or none should.
* **CC302** — ``Condition.wait()`` with no enclosing ``while`` loop:
  wakeups are spurious, the predicate must be re-checked in a loop
  (``wait_for`` embeds the loop and is not flagged).

Single-thread-owned attributes (never touched under any lock) produce no
findings — the lint enforces *consistency* of an adopted lock protocol,
not lock-everything.
"""
from __future__ import annotations

import ast
import dataclasses

from repro_torch.analysis.findings import Finding

_LOCK_TYPES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "remove", "clear", "add", "discard", "update", "setdefault",
    "sort", "reverse", "popitem",
}


@dataclasses.dataclass(frozen=True)
class Access:
    attr: str
    kind: str           # "read" | "write"
    method: str
    line: int
    locked: bool


def _lock_attrs(cls: ast.ClassDef) -> dict[str, str]:
    """self-attr name -> lock type, from assignments anywhere in the class."""
    out: dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            fn = node.value.func
            type_name = None
            if isinstance(fn, ast.Attribute) and fn.attr in _LOCK_TYPES \
                    and isinstance(fn.value, ast.Name) \
                    and fn.value.id == "threading":
                type_name = fn.attr
            elif isinstance(fn, ast.Name) and fn.id in _LOCK_TYPES:
                type_name = fn.id
            if type_name:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) \
                            and isinstance(tgt.value, ast.Name) \
                            and tgt.value.id == "self":
                        out[tgt.attr] = type_name
    return out


def _self_attr(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


class _MethodWalker:
    """Collect accesses + wait() calls in one method, tracking held locks."""

    def __init__(self, method: str, locks: dict[str, str]):
        self.method = method
        self.locks = locks
        self.accesses: list[Access] = []
        self.waits: list[tuple[str, int, bool]] = []  # (attr, line, in_while)
        self._held = 0
        self._while_depth = 0
        self._write_nodes: set[int] = set()   # id() of Attribute nodes that
        # are the *target* of a write (so the generic read walk skips them)

    def _record(self, attr: str, kind: str, line: int):
        if attr in self.locks:
            return
        self.accesses.append(Access(attr=attr, kind=kind, method=self.method,
                                    line=line, locked=self._held > 0))

    def walk(self, node: ast.AST):
        if isinstance(node, ast.With):
            held_here = 0
            for item in node.items:
                ctx = item.context_expr
                attr = _self_attr(ctx)
                if attr is None and isinstance(ctx, ast.Call):
                    attr = _self_attr(ctx.func)   # e.g. self._cv.acquire()
                if attr in self.locks:
                    held_here += 1
            self._held += held_here
            for item in node.items:
                self.walk(item.context_expr)
            for child in node.body:
                self.walk(child)
            self._held -= held_here
            return
        if isinstance(node, ast.While):
            self._while_depth += 1
            for child in ast.iter_child_nodes(node):
                self.walk(child)
            self._while_depth -= 1
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                base = tgt
                if isinstance(base, (ast.Subscript,)):
                    base = base.value
                attr = _self_attr(base)
                if attr is not None:
                    self._record(attr, "write", node.lineno)
                    self._write_nodes.add(id(base))
                    if isinstance(node, ast.AugAssign):
                        # += reads, then writes
                        self._record(attr, "read", node.lineno)
                else:
                    self.walk(tgt)
            if isinstance(node, ast.AnnAssign):
                if node.value is not None:
                    self.walk(node.value)
            else:
                self.walk(node.value)
            return
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute):
                recv_attr = _self_attr(fn.value)
                if recv_attr is not None:
                    if recv_attr in self.locks and fn.attr == "wait":
                        self.waits.append((recv_attr, node.lineno,
                                           self._while_depth > 0))
                    elif fn.attr in _MUTATORS:
                        self._record(recv_attr, "write", node.lineno)
                        self._write_nodes.add(id(fn.value))
            for child in ast.iter_child_nodes(node):
                self.walk(child)
            return
        attr = _self_attr(node)
        if attr is not None and id(node) not in self._write_nodes \
                and isinstance(node.ctx, ast.Load):
            self._record(attr, "read", node.lineno)
        for child in ast.iter_child_nodes(node):
            self.walk(child)


def _scan_class(cls: ast.ClassDef, relpath: str) -> list[Finding]:
    locks = _lock_attrs(cls)
    if not locks:
        return []
    findings: list[Finding] = []
    accesses: list[Access] = []
    for node in cls.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        w = _MethodWalker(node.name, locks)
        for child in node.body:
            w.walk(child)
        for attr, line, in_while in w.waits:
            if not in_while:
                findings.append(Finding(
                    code="CC302", path=relpath, line=line,
                    scope=f"{cls.name}.{node.name}",
                    message=f"self.{attr}.wait() without an enclosing "
                            "while-predicate loop (spurious wakeups)"))
        if node.name != "__init__":
            accesses.extend(w.accesses)

    by_attr: dict[str, list[Access]] = {}
    for a in accesses:
        by_attr.setdefault(a.attr, []).append(a)
    for attr, accs in sorted(by_attr.items()):
        locked = [a for a in accs if a.locked]
        unlocked = [a for a in accs if not a.locked]
        if not locked or not unlocked:
            continue
        locked_writes = [a for a in locked if a.kind == "write"]
        flagged: list[Access] = []
        if locked_writes:
            flagged = unlocked                  # protocol: attr is lock-guarded
        elif any(a.kind == "write" for a in unlocked):
            flagged = [a for a in unlocked if a.kind == "write"]
        for a in flagged:
            other = locked_writes[0] if locked_writes else locked[0]
            findings.append(Finding(
                code="CC301", path=relpath, line=a.line,
                scope=f"{cls.name}.{a.method}",
                message=f"self.{attr} {a.kind} without the lock, but "
                        f"{other.method}:{other.line} accesses it under "
                        "one"))
    return findings


def scan_source(source: str, relpath: str) -> list[Finding]:
    """Run the concurrency pass over one module's source."""
    tree = ast.parse(source, filename=relpath)
    findings: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_scan_class(node, relpath))
    return findings
