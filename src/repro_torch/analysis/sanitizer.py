"""Runtime AMI protocol sanitizer — a TSan-style shadow-state checker.

``AmuConfig(sanitize=True)`` attaches one :class:`AmiSanitizer` per
engine+scheduler stack (every rack core gets its own). The sanitizer
observes the duck-typed hooks the engine and scheduler expose and keeps
shadow state only:

* an **SPM shadow allocation map** — one ``int64`` per SPM data byte,
  holding the rid of the in-flight LOAD targeting that byte (0 = free).
  Synchronous ``spm_read``/``spm_write`` and astore payload captures that
  touch a nonzero byte are data races; a new load landing on a nonzero
  byte is an overlapping in-flight DMA destination. This is the scalar
  oracle's ``_assert_no_inflight_load_overlap`` promoted to a uniform
  contract across the batched and epoch-fused engines (which otherwise
  check nothing) — same message format, plus rid/port attribution.
* a **rid/token lifecycle tracker** — every wait token the scheduler
  mints must be awaited before the port exits; :meth:`finish` raises a
  leak report for issued-never-awaited tokens (a leaked AMART entry in
  hardware).
* a **lock-order graph** — ``Acquire``/``AcquireVec`` edges (held -> new)
  with incremental cycle detection (a cycle is a potential disambiguator
  deadlock, reported *before* the simulated deadlock fires), duplicate
  same-task acquires (self-deadlock), releases of un-held blocks, and
  the AcquireVec ascending/distinct contract.

Neutrality is the design invariant: hooks never touch the clock, the
far-model RNG, stats, traces, or any engine/scheduler state — with
``sanitize=True`` every run is bit-identical to ``sanitize=False``
(tests/test_sanitizer.py pins traces, stats and RNG bitstreams).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.core.engine import LOAD, format_race


class AmiProtocolError(AssertionError):
    """An AMI protocol violation caught by the runtime sanitizer."""


class AmiSanitizer:
    """Shadow-state checker for one engine + scheduler stack.

    Wire-up (done by :class:`repro_torch.amu.session.AmuSession` /
    ``RackSession`` when ``AmuConfig(sanitize=True)``)::

        san = AmiSanitizer(port=inst.name, label="core3")
        san.attach(engine, scheduler)
        ... run ...
        san.finish()      # leak report (raises AmiProtocolError)
    """

    def __init__(self, port: str = "", label: str = ""):
        self.port = port
        self.label = label
        self.engine = None
        self.sched = None
        # SPM shadow map + rid-indexed in-flight load windows (SoA mirror)
        self._shadow = np.empty(0, np.int64)
        self._w_lo = np.empty(0, np.int64)
        self._w_sz = np.empty(0, np.int64)
        # token lifecycle: tokens are minted sequentially (1.._tok); the
        # awaited set is cleared when the scheduler recycles its maps (a
        # quiesce point — leaked tokens block recycling via the unclaimed
        # count, so nothing under suspicion is ever dropped)
        self._awaited: Set[int] = set()
        # lock plane: per-task held block lists + global order graph
        self._held: Dict[int, List[int]] = {}
        self._edges: Dict[int, Set[int]] = {}
        self._block_shift = 6

    # ------------------------------------------------------------- wiring
    def attach(self, engine, sched) -> None:
        self.engine = engine
        self.sched = sched
        engine.sanitizer = self
        sched._san = self
        self._shadow = np.zeros(engine.spm_data_bytes, np.int64)
        cap = engine.config.queue_length
        self._w_lo = np.zeros(cap + 1, np.int64)
        self._w_sz = np.zeros(cap + 1, np.int64)
        if sched.disamb is not None:
            self._block_shift = sched.disamb.block_shift

    def _where(self) -> str:
        return f"{self.label}: " if self.label else ""

    def _grow_windows(self, rid: int) -> None:
        extra = rid + 1 - self._w_lo.size
        self._w_lo = np.concatenate([self._w_lo, np.zeros(extra, np.int64)])
        self._w_sz = np.concatenate([self._w_sz, np.zeros(extra, np.int64)])

    # ------------------------------------------------------- engine hooks
    def on_issue(self, kind: int, rid: int, spm_addr: int, size: int) -> None:
        """A scalar aload/astore was issued (request now in flight)."""
        win = self._shadow[spm_addr:spm_addr + size]
        nz = win.nonzero()[0]
        if nz.size:
            other = int(win[nz[0]])
            what = ("aload destination" if kind == LOAD
                    else "astore payload capture")
            raise AmiProtocolError(format_race(
                self._where(), what, spm_addr, spm_addr + size, other,
                int(self._w_lo[other]),
                int(self._w_lo[other] + self._w_sz[other]), self.port))
        if kind == LOAD:
            if rid >= self._w_lo.size:
                self._grow_windows(rid)
            win[:] = rid
            self._w_lo[rid] = spm_addr
            self._w_sz[rid] = size

    def on_issue_batch(self, kind: int, rids, spm_addrs, sizes) -> None:
        """A whole issue batch (aload_batch/astore_batch/stage_epoch)."""
        k = len(rids)
        if k == 0:
            return
        if k == 1:
            self.on_issue(kind, int(rids[0]), int(spm_addrs[0]),
                          int(sizes[0]))
            return
        spm_addrs = np.asarray(spm_addrs, np.int64)
        sizes = np.asarray(sizes, np.int64)
        if (sizes == sizes[0]).all():
            g = int(sizes[0])
            flat = (spm_addrs[:, None] + np.arange(g)).ravel()
        else:
            flat = np.concatenate(
                [np.arange(a, a + s) for a, s in
                 zip(spm_addrs.tolist(), sizes.tolist())])
        vals = self._shadow[flat]
        nz = vals.nonzero()[0]
        if nz.size:
            i = int(nz[0])
            other = int(vals[i])
            what = ("aload destination" if kind == LOAD
                    else "astore payload capture")
            raise AmiProtocolError(format_race(
                self._where(), what, int(flat[i]), int(flat[i]) + 1, other,
                int(self._w_lo[other]),
                int(self._w_lo[other] + self._w_sz[other]), self.port))
        if kind != LOAD:
            return
        if np.unique(flat).size != flat.size:
            raise AmiProtocolError(
                f"{self._where()}aload batch has overlapping destination "
                f"windows within one issue (port {self.port!r})")
        rids = np.asarray(rids, np.int64)
        if int(rids.max()) >= self._w_lo.size:
            self._grow_windows(int(rids.max()))
        self._shadow[flat] = np.repeat(rids, sizes)
        self._w_lo[rids] = spm_addrs
        self._w_sz[rids] = sizes

    def on_retire(self, rids) -> None:
        """Requests retired by ``advance`` — their DMA is no longer in
        flight (failed requests included: the window is released even
        though no data moved)."""
        rids = np.asarray(rids, np.int64)
        if rids.size == 0:
            return
        rids = rids[rids < self._w_lo.size]
        sz = self._w_sz[rids]
        loads = rids[sz > 0]
        if loads.size == 0:
            return
        lo = self._w_lo[loads]
        g = self._w_sz[loads]
        if (g == g[0]).all():
            self._shadow[(lo[:, None] + np.arange(int(g[0]))).ravel()] = 0
        else:
            for a, s in zip(lo.tolist(), g.tolist()):
                self._shadow[a:a + s] = 0
        self._w_sz[loads] = 0

    def on_spm_access(self, spm_addr: int, size: int, what: str) -> None:
        """Synchronous spm_read/spm_write about to touch [addr, addr+size)."""
        win = self._shadow[spm_addr:spm_addr + size]
        nz = win.nonzero()[0]
        if nz.size:
            rid = int(win[nz[0]])
            raise AmiProtocolError(format_race(
                self._where(), what, spm_addr, spm_addr + size, rid,
                int(self._w_lo[rid]), int(self._w_lo[rid] + self._w_sz[rid]),
                self.port))

    # ---------------------------------------------------- scheduler hooks
    def on_await(self, toks) -> None:
        """Tokens passed to ``_await_tokens`` (issued -> awaited)."""
        self._awaited.update(int(t) for t in toks)

    def on_token_recycle(self) -> None:
        """The scheduler recycled its token maps at a quiesce point; token
        numbering restarts, and every outstanding token was awaited (leaked
        tokens hold the unclaimed count nonzero, which blocks recycling)."""
        self._awaited.clear()

    def on_acquire(self, tid: int, addrs, vec: bool = False) -> None:
        """Task `tid` acquires lock blocks for `addrs` (in order)."""
        if vec:
            seq = [int(a) for a in addrs]
            if seq != sorted(set(seq)):
                raise AmiProtocolError(
                    f"{self._where()}AcquireVec addrs must be strictly "
                    f"ascending and distinct (port {self.port!r}): {seq[:8]}")
        held = self._held.setdefault(tid, [])
        for a in addrs:
            b = int(a) >> self._block_shift
            if b in held:
                raise AmiProtocolError(
                    f"{self._where()}task re-acquires lock block {b} it "
                    f"already holds — self-deadlock (port {self.port!r})")
            for h in held:
                self._order_edge(h, b)
            held.append(b)

    def on_release(self, tid: int, addrs) -> None:
        held = self._held.get(tid)
        for a in addrs:
            b = int(a) >> self._block_shift
            if held is None or b not in held:
                raise AmiProtocolError(
                    f"{self._where()}Release of lock block {b} that the "
                    f"task does not hold (port {self.port!r})")
            held.remove(b)

    def _order_edge(self, u: int, v: int) -> None:
        """Record lock-order edge u -> v; a path v ~> u means adding it
        closes a cycle — two tasks can interleave into a deadlock."""
        succ = self._edges.setdefault(u, set())
        if v in succ:
            return
        path = self._find_path(v, u)
        if path is not None:
            cyc = " -> ".join(str(b) for b in [u, v, *path[1:]])
            raise AmiProtocolError(
                f"{self._where()}lock-order cycle {cyc} (port "
                f"{self.port!r}); acquire blocks in one global ascending "
                f"order (see workloads._lock_set)")
        succ.add(v)

    def _find_path(self, src: int, dst: int) -> Optional[List[int]]:
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # ------------------------------------------------------- exit report
    def finish(self) -> None:
        """Port-exit leak report: raises on issued-never-awaited tokens and
        on locks still held after every task finished."""
        sched = self.sched
        if sched is not None:
            hi = int(sched._tok)
            leaked = [t for t in range(1, hi + 1) if t not in self._awaited]
            if leaked:
                raise AmiProtocolError(
                    f"{self._where()}port {self.port!r} leaked "
                    f"{len(leaked)} request token(s) — issued but never "
                    f"awaited (leaked AMART entries): {leaked[:8]}"
                    f"{'...' if len(leaked) > 8 else ''}")
        still = sorted(b for blocks in self._held.values() for b in blocks)
        if still:
            raise AmiProtocolError(
                f"{self._where()}port {self.port!r} exited holding "
                f"{len(still)} lock block(s) (Acquire without Release): "
                f"{still[:8]}{'...' if len(still) > 8 else ''}")
