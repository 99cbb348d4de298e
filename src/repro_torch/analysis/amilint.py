"""amilint — static AST + abstract-interpretation lint for AMI ports.

A *port generator* is any function whose own body (nested defs excluded)
yields at least one ``ctx.<method>(...)`` facade call or raw command
construction (``Aload(...)`` etc.). For each one, six rule families run:

======  =================================================================
AMI001  leaked request ID: a ``wait=False`` issue whose token is
        discarded, never flows into any ``await_rid``/``await_rids``
        (directly or through a container), or is only awaited on some
        conditional path.
AMI002  SPM race: an ``spm_read``/``spm_write`` whose window may overlap
        the destination of an in-flight ``wait=False`` load (interval
        abstract interpretation over normalized ``base + const`` SPM
        address expressions; awaiting the token clears its window).
AMI003  lock matching: ``Acquire`` without a matching ``Release`` (and
        vice versa), ``acquire_vec`` without the paired ``release_vec``.
AMI004  lock order: constant scalar acquires held simultaneously in
        non-ascending/duplicated order; ``acquire_vec`` over a literal
        list that is not strictly ascending and distinct.
AMI005  non-command yield: a yield whose value cannot be an AMI command
        (bare yield, unknown ``ctx`` method, arbitrary expression).
AMI006  engine bypass: a direct call to an engine-surface method
        (``aload``/``getfin``/``spm_read``/...) on anything but ``ctx``.
======  =================================================================

False positives are suppressed per line with ``# amilint: ignore`` or
``# amilint: ignore[AMI002,AMI005]``.

The pass is deliberately conservative: token flow follows simple
assignments, ``append``/``extend`` and subscript stores; loop bodies are
interpreted once (windows issued in a loop and awaited in a later loop —
the pipelined-port idiom — do not re-trigger across the back edge); a
race is only reported when the normalized base expressions match.
"""
from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: ctx facade methods (cross-checked against CommandFacade in the tests).
FACADE_METHODS = {
    "aload", "astore", "aload_vec", "astore_vec", "await_rid", "await_rids",
    "acquire", "release", "acquire_vec", "release_vec", "spm_read",
    "spm_write", "cost", "wait_until", "now",
}

#: Raw command classes a port may construct instead of the facade.
COMMAND_CLASSES = {
    "Aload", "Astore", "AloadNoWait", "AstoreNoWait", "AloadVec",
    "AstoreVec", "AwaitRid", "AwaitRids", "Acquire", "Release",
    "AcquireVec", "ReleaseVec", "SpmRead", "SpmWrite", "Cost", "WaitUntil",
    "Now",
}

#: Engine-surface methods a port must never call directly (AMI006); the
#: scheduler owns the engine — ports speak only through yielded commands.
ENGINE_SURFACE = {
    "aload", "astore", "aload_batch", "astore_batch", "getfin",
    "getfin_all", "stage_epoch", "flush_epoch", "getfin_epoch",
    "spm_read", "spm_write",
}

_SUPPRESS_RE = re.compile(r"#\s*amilint:\s*ignore(?:\[([A-Z0-9,\s]+)\])?")


@dataclass
class Finding:
    rule: str
    message: str
    file: str
    line: int
    col: int
    func: str

    def __str__(self) -> str:
        return (f"{self.file}:{self.line}:{self.col}: {self.rule} "
                f"{self.message} [in {self.func}]")

    def to_dict(self) -> dict:
        return {"rule": self.rule, "message": self.message,
                "file": self.file, "line": self.line, "col": self.col,
                "func": self.func}


# ========================================================================
# AST helpers
# ========================================================================

def _walk_own(node: ast.AST):
    """Yield descendants of `node`, not descending into nested function
    definitions (each generator is analyzed on its own)."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        yield from _walk_own(child)


def _ctx_method(call: ast.AST) -> Optional[str]:
    """``ctx.<m>(...)`` -> ``m``; anything else -> None."""
    if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
            and isinstance(call.func.value, ast.Name)
            and call.func.value.id == "ctx"):
        return call.func.attr
    return None


def _command_class(call: ast.AST) -> Optional[str]:
    """``Aload(...)`` (or any known command class) -> class name."""
    if (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
            and call.func.id in COMMAND_CLASSES):
        return call.func.id
    return None


def _arg(call: ast.Call, idx: int, name: str) -> Optional[ast.AST]:
    if idx < len(call.args):
        return call.args[idx]
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _const_int(node: Optional[ast.AST]) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add,
                                                            ast.Sub,
                                                            ast.Mult)):
        lo = _const_int(node.left)
        ro = _const_int(node.right)
        if lo is not None and ro is not None:
            if isinstance(node.op, ast.Add):
                return lo + ro
            if isinstance(node.op, ast.Sub):
                return lo - ro
            return lo * ro
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _const_int(node.operand)
        return -v if v is not None else None
    return None


def _norm_addr(node: Optional[ast.AST]) -> Tuple[Optional[str], int]:
    """Normalize an SPM address expression into (base, const_offset):
    ``slot + 8`` -> ("slot", 8), ``64`` -> (None, 64), anything else ->
    (dump-of-base, folded offset). Two addresses are only comparable when
    their bases are equal."""
    if node is None:
        return ("<none>", 0)
    c = _const_int(node)
    if c is not None:
        return (None, c)
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add,
                                                            ast.Sub)):
        rc = _const_int(node.right)
        if rc is not None:
            base, off = _norm_addr(node.left)
            return (base if base is not None else "<const>",
                    off + (rc if isinstance(node.op, ast.Add) else -rc))
        lc = _const_int(node.left)
        if lc is not None and isinstance(node.op, ast.Add):
            base, off = _norm_addr(node.right)
            return (base if base is not None else "<const>", off + lc)
    return (ast.dump(node), 0)


def _names_in(node: Optional[ast.AST]) -> Set[str]:
    if node is None:
        return set()
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _wait_of(call: ast.Call, method: Optional[str],
             cls: Optional[str]) -> bool:
    """Does this issue command suspend until completion (wait=True)?"""
    if cls in ("AloadNoWait", "AstoreNoWait"):
        return False
    if cls in ("AloadVec", "AstoreVec"):
        w = _arg(call, 3, "wait")
        if w is None:
            return False                  # dataclass default: wait=False
        return not (isinstance(w, ast.Constant) and w.value is False)
    # facade: aload/astore/aload_vec/astore_vec default wait=True
    for kw in call.keywords:
        if kw.arg == "wait":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is False)
    return True


@dataclass
class _Window:
    """An in-flight wait=False load destination [base+off, base+off+size)."""
    base: Optional[str]
    off: int
    size: Optional[int]            # None = unknown (treated as 1 byte)
    toks: frozenset                # names the wait token may flow into
    line: int

    def overlaps(self, base, off, size) -> bool:
        if self.base != base:
            return False
        a0, a1 = self.off, self.off + (self.size or 1)
        b0, b1 = off, off + (size or 1)
        return a0 < b1 and b0 < a1


# ========================================================================
# Per-function analysis
# ========================================================================

class _FuncLinter:
    def __init__(self, fn: ast.FunctionDef, filename: str,
                 findings: List[Finding]):
        self.fn = fn
        self.filename = filename
        self.findings = findings
        self.flow = self._flow_edges()

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule, message, self.filename, getattr(node, "lineno", 0),
            getattr(node, "col_offset", 0), self.fn.name))

    # ------------------------------------------------------ name flow
    def _flow_edges(self) -> Dict[str, Set[str]]:
        """name -> names it flows into, via assignment / append / extend /
        subscript store (one hop; closures take the transitive closure)."""
        edges: Dict[str, Set[str]] = {}
        for node in _walk_own(self.fn):
            if isinstance(node, ast.Assign):
                srcs = _names_in(node.value)
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        for s in srcs:
                            edges.setdefault(s, set()).add(tgt.id)
                    elif isinstance(tgt, ast.Subscript) and \
                            isinstance(tgt.value, ast.Name):
                        for s in srcs:
                            edges.setdefault(s, set()).add(tgt.value.id)
            elif isinstance(node, ast.AugAssign) and \
                    isinstance(node.target, ast.Name):
                for s in _names_in(node.value):
                    edges.setdefault(s, set()).add(node.target.id)
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in ("append", "extend", "add")
                  and isinstance(node.func.value, ast.Name)):
                for a in node.args:
                    for s in _names_in(a):
                        edges.setdefault(s, set()).add(node.func.value.id)
        return edges

    def closure(self, name: str) -> frozenset:
        seen = {name}
        queue = [name]
        while queue:
            for nxt in self.flow.get(queue.pop(), ()):
                if nxt not in seen:
                    seen.add(nxt)
                    queue.append(nxt)
        return frozenset(seen)

    # -------------------------------------------------------- structure
    def _parents(self) -> Dict[ast.AST, ast.AST]:
        par: Dict[ast.AST, ast.AST] = {}
        stack = [self.fn]
        while stack:
            node = stack.pop()
            for child in ast.iter_child_nodes(node):
                par[child] = node
                if not isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef, ast.Lambda)):
                    stack.append(child)
        return par

    def _if_chain(self, node: ast.AST,
                  parents: Dict[ast.AST, ast.AST]) -> Set[int]:
        """ids of the If nodes (branch bodies) strictly enclosing `node`."""
        chain: Set[int] = set()
        cur = node
        while cur in parents:
            nxt = parents[cur]
            if isinstance(nxt, ast.If):
                chain.add(id(nxt))
            cur = nxt
        return chain

    # ------------------------------------------------------------- run
    def run(self) -> None:
        self._lint_yields_and_bypass()
        self._lint_leaks()
        self._lint_spm_races()
        self._lint_locks()

    # ------------------------------------------- AMI005 / AMI006
    def _lint_yields_and_bypass(self) -> None:
        for node in _walk_own(self.fn):
            if isinstance(node, ast.Yield):
                v = node.value
                if v is None:
                    self.emit("AMI005", node,
                              "bare yield — every yield must produce an "
                              "AMI command (ctx.<op>(...))")
                    continue
                m = _ctx_method(v)
                if m is not None:
                    if m not in FACADE_METHODS:
                        self.emit("AMI005", v,
                                  f"unknown ctx method ctx.{m}(...) — not "
                                  f"part of the AMI command facade")
                    continue
                if _command_class(v) is not None:
                    continue
                self.emit("AMI005", v,
                          "yield of a non-command expression — ports must "
                          "yield ctx.<op>(...) (or a command dataclass)")
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in ENGINE_SURFACE
                  and not (isinstance(node.func.value, ast.Name)
                           and node.func.value.id == "ctx")):
                recv = (node.func.value.id
                        if isinstance(node.func.value, ast.Name)
                        else ast.unparse(node.func.value)
                        if hasattr(ast, "unparse") else "<expr>")
                self.emit("AMI006", node,
                          f"direct engine call {recv}.{node.func.attr}(...) "
                          f"bypasses the ctx command facade — the scheduler "
                          f"owns the engine")

    # --------------------------------------------------------- AMI001
    def _issues(self) -> List[dict]:
        """Every wait=False issue yield, with its token binding."""
        parents = self._parents()
        out = []
        for node in _walk_own(self.fn):
            if not isinstance(node, ast.Yield) or node.value is None:
                continue
            call = node.value
            m = _ctx_method(call)
            cls = _command_class(call)
            if m in ("aload", "astore", "aload_vec", "astore_vec"):
                kind = "load" if m.startswith("aload") else "store"
            elif cls in ("Aload", "Astore", "AloadNoWait", "AstoreNoWait",
                         "AloadVec", "AstoreVec"):
                kind = "load" if "load" in cls.lower() else "store"
            else:
                continue
            if not isinstance(call, ast.Call) or _wait_of(call, m, cls):
                continue
            parent = parents.get(node)
            tok: Optional[str] = None
            discarded = False
            if isinstance(parent, ast.Expr):
                discarded = True
            elif isinstance(parent, ast.Assign) and len(parent.targets) == 1 \
                    and isinstance(parent.targets[0], ast.Name):
                tok = parent.targets[0].id
            out.append({"node": node, "call": call, "kind": kind,
                        "tok": tok, "discarded": discarded,
                        "parents": parents})
        return out

    def _await_nodes(self) -> List[Tuple[ast.AST, Set[str]]]:
        out = []
        for node in _walk_own(self.fn):
            m = _ctx_method(node)
            cls = _command_class(node)
            if m in ("await_rid", "await_rids") or cls in ("AwaitRid",
                                                           "AwaitRids"):
                names: Set[str] = set()
                for a in node.args:
                    names |= _names_in(a)
                for kw in node.keywords:
                    names |= _names_in(kw.value)
                out.append((node, names))
        return out

    def _lint_leaks(self) -> None:
        issues = self._issues()
        if not issues:
            return
        awaits = self._await_nodes()
        for iss in issues:
            node = iss["node"]
            if iss["discarded"]:
                self.emit("AMI001", node,
                          f"wait=False {iss['kind']} issue discards its "
                          f"wait token — the request ID leaks (no await "
                          f"ever retires it)")
                continue
            if iss["tok"] is None:
                continue                 # bound into a structure we can't
            clo = self.closure(iss["tok"])      # follow: stay quiet
            hits = [(n, names) for n, names in awaits if clo & names]
            if not hits:
                self.emit("AMI001", node,
                          f"wait token {iss['tok']!r} from this "
                          f"wait=False {iss['kind']} never reaches an "
                          f"await_rid/await_rids — leaked request ID")
                continue
            parents = iss["parents"]
            issue_ifs = self._if_chain(node, parents)
            if all(self._if_chain(n, parents) - issue_ifs for n, _ in hits):
                self.emit("AMI001", node,
                          f"wait token {iss['tok']!r} is only awaited "
                          f"inside a conditional branch — the request ID "
                          f"may leak on some path")

    # --------------------------------------------------------- AMI002
    def _lint_spm_races(self) -> None:
        self._scan_block(self.fn.body, [])

    def _scan_block(self, stmts: Sequence[ast.stmt],
                    state: List[_Window]) -> List[_Window]:
        for stmt in stmts:
            if isinstance(stmt, (ast.For, ast.While)):
                # one abstract iteration; windows awaited inside the body
                # stay cleared (out = body_out, which is (in - awaited) +
                # surviving additions). Back-edge races are not modeled.
                state = self._scan_block(stmt.body, state)
                state = self._scan_block(stmt.orelse, state)
            elif isinstance(stmt, ast.If):
                a = self._scan_block(stmt.body, list(state))
                b = self._scan_block(stmt.orelse, list(state))
                merged: List[_Window] = []
                seen: Set[int] = set()
                for w in a + b:
                    if id(w) not in seen:
                        seen.add(id(w))
                        merged.append(w)
                state = merged
            elif isinstance(stmt, ast.With):
                state = self._scan_block(stmt.body, state)
            elif isinstance(stmt, ast.Try):
                state = self._scan_block(stmt.body, state)
                for h in stmt.handlers:
                    state = self._scan_block(h.body, state)
                state = self._scan_block(stmt.orelse, state)
                state = self._scan_block(stmt.finalbody, state)
            else:
                state = self._scan_simple(stmt, state)
        return state

    def _scan_simple(self, stmt: ast.stmt,
                     state: List[_Window]) -> List[_Window]:
        events = []
        for node in _walk_own(stmt):
            m = _ctx_method(node)
            cls = _command_class(node)
            if m is not None or cls is not None:
                events.append((getattr(node, "lineno", 0),
                               getattr(node, "col_offset", 0), node, m, cls))
        events.sort(key=lambda e: (e[0], e[1]))
        tok_name = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            tok_name = stmt.targets[0].id
        for _, _, call, m, cls in events:
            state = self._apply_event(stmt, call, m, cls, tok_name, state)
        return state

    def _apply_event(self, stmt, call, m, cls, tok_name,
                     state: List[_Window]) -> List[_Window]:
        # awaits clear the windows their tokens flow into
        if m in ("await_rid", "await_rids") or cls in ("AwaitRid",
                                                       "AwaitRids"):
            names: Set[str] = set()
            for a in call.args:
                names |= _names_in(a)
            for kw in call.keywords:
                names |= _names_in(kw.value)
            return [w for w in state if not (w.toks & names)]
        # synchronous SPM accesses race against live windows
        if m == "spm_read" or cls == "SpmRead":
            base, off = _norm_addr(_arg(call, 0, "spm"))
            size = _const_int(_arg(call, 1, "size"))
            self._check_race(call, "spm_read", base, off, size, state)
            return state
        if m == "spm_write" or cls == "SpmWrite":
            base, off = _norm_addr(_arg(call, 0, "spm"))
            self._check_race(call, "spm_write", base, off, None, state)
            return state
        # issues: wait=False loads open windows
        is_load = (m in ("aload", "aload_vec")
                   or cls in ("Aload", "AloadNoWait", "AloadVec"))
        is_store = (m in ("astore", "astore_vec")
                    or cls in ("Astore", "AstoreNoWait", "AstoreVec"))
        if not (is_load or is_store):
            return state
        if _wait_of(call, m, cls):
            return state                     # wait=True: retired on resume
        if not is_load:
            return state                     # store payload captured at issue
        toks = self.closure(tok_name) if tok_name else frozenset()
        vec = m in ("aload_vec",) or cls == "AloadVec"
        spm = _arg(call, 0, "spm")
        size = _const_int(_arg(call, 2, "size"))
        if vec:
            base = ast.dump(spm) if spm is not None else "<none>"
            win = _Window(base, 0, None, toks, getattr(call, "lineno", 0))
        else:
            base, off = _norm_addr(spm)
            win = _Window(base, off, size, toks, getattr(call, "lineno", 0))
        state = list(state)
        state.append(win)
        return state

    def _check_race(self, node, what, base, off, size,
                    state: List[_Window]) -> None:
        for w in state:
            if w.overlaps(base, off, size):
                self.emit("AMI002", node,
                          f"{what} may overlap the destination of the "
                          f"in-flight wait=False aload issued at line "
                          f"{w.line} — await its token first")
                return

    # --------------------------------------------------- AMI003 / AMI004
    def _lint_locks(self) -> None:
        acquires: List[Tuple[str, ast.AST, Optional[int]]] = []
        releases: List[Tuple[str, ast.AST]] = []
        vec_acq: List[Tuple[str, ast.AST]] = []
        vec_rel: List[Tuple[str, ast.AST]] = []
        ordered = []
        for node in _walk_own(self.fn):
            m = _ctx_method(node)
            cls = _command_class(node)
            if m is None and cls is None:
                continue
            key = m or {"Acquire": "acquire", "Release": "release",
                        "AcquireVec": "acquire_vec",
                        "ReleaseVec": "release_vec"}.get(cls)
            if key not in ("acquire", "release", "acquire_vec",
                           "release_vec"):
                continue
            arg = _arg(node, 0, "addr" if key in ("acquire", "release")
                       else "addrs")
            dump = ast.dump(arg) if arg is not None else "<none>"
            ordered.append((getattr(node, "lineno", 0),
                            getattr(node, "col_offset", 0), key, node, arg,
                            dump))
        ordered.sort(key=lambda e: (e[0], e[1]))
        held_consts: List[Tuple[int, ast.AST]] = []
        for _, _, key, node, arg, dump in ordered:
            if key == "acquire":
                acquires.append((dump, node, _const_int(arg)))
                c = _const_int(arg)
                if c is not None:
                    for h, _ in held_consts:
                        if c <= h:
                            self.emit(
                                "AMI004", node,
                                f"acquire({c}) while holding lock {h} "
                                f"breaks the ascending lock order — "
                                f"deadlock risk across tasks")
                            break
                    held_consts.append((c, node))
            elif key == "release":
                releases.append((dump, node))
                c = _const_int(arg)
                if c is not None:
                    held_consts = [(h, n) for h, n in held_consts if h != c]
            elif key == "acquire_vec":
                vec_acq.append((dump, node))
                if isinstance(arg, (ast.List, ast.Tuple)):
                    consts = [_const_int(e) for e in arg.elts]
                    if all(c is not None for c in consts) and \
                            consts != sorted(set(consts)):
                        self.emit(
                            "AMI004", node,
                            f"acquire_vec addrs {consts} are not strictly "
                            f"ascending and distinct — the AcquireVec "
                            f"contract (see workloads._lock_set)")
            else:
                vec_rel.append((dump, node))
        rel_dumps = [d for d, _ in releases]
        for dump, node, _ in acquires:
            if dump in rel_dumps:
                rel_dumps.remove(dump)
            else:
                self.emit("AMI003", node,
                          "Acquire without a matching Release of the same "
                          "address — the lock block is held forever")
        for dump in set(rel_dumps):
            node = next(n for d, n in releases if d == dump)
            self.emit("AMI003", node,
                      "Release without a matching Acquire of the same "
                      "address")
        va = [d for d, _ in vec_acq]
        for dump, node in vec_acq:
            if dump not in (d for d, _ in vec_rel):
                self.emit("AMI003", node,
                          "acquire_vec without a matching release_vec of "
                          "the same lock set")
        for dump, node in vec_rel:
            if dump not in va:
                self.emit("AMI003", node,
                          "release_vec without a matching acquire_vec of "
                          "the same lock set")


# ========================================================================
# Module / file / registry entry points
# ========================================================================

def _is_port_generator(fn: ast.FunctionDef) -> bool:
    for node in _walk_own(fn):
        if isinstance(node, ast.Yield) and node.value is not None:
            if _ctx_method(node.value) is not None or \
                    _command_class(node.value) is not None:
                return True
    return False


def _suppressions(src: str) -> Dict[int, Optional[Set[str]]]:
    """line -> None (suppress all) or set of rules to suppress."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            rules = m.group(1)
            out[i] = ({r.strip() for r in rules.split(",")} if rules
                      else None)
    return out


def lint_source(src: str, filename: str = "<string>") -> List[Finding]:
    """Lint every port generator in `src`; returns surviving findings."""
    tree = ast.parse(src, filename=filename)
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and _is_port_generator(node):
            _FuncLinter(node, filename, findings).run()
    sup = _suppressions(src)
    kept = []
    for f in findings:
        rules = sup.get(f.line, False)
        if rules is False:
            kept.append(f)
        elif rules is not None and f.rule not in rules:
            kept.append(f)
    kept.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return kept


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), filename=path)


def lint_registry(registry=None) -> List[Finding]:
    """Lint the source module of every registered ``@workload`` builder
    (deduplicated): the in-repo ports plus anything the caller imported."""
    if registry is None:
        from repro_torch.amu import REGISTRY as registry
    findings: List[Finding] = []
    for path in registry.source_files():
        findings.extend(lint_file(path))
    return findings


def render(findings: List[Finding], as_json: bool = False) -> str:
    if as_json:
        return json.dumps({"findings": [f.to_dict() for f in findings],
                           "count": len(findings)}, indent=2)
    if not findings:
        return "amilint: 0 findings"
    lines = [str(f) for f in findings]
    lines.append(f"amilint: {len(findings)} finding(s)")
    return "\n".join(lines)
