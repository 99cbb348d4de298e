"""Coroutine programming framework (§5.2) with a timed runtime.

Python generators stand in for the paper's C++20 coroutines. A task yields
*commands*; the scheduler implements Figure 4's runtime loop:

  1. a task yields :class:`Aload`/:class:`Astore` -> the engine issues the
     request (the instruction retires immediately), the task suspends on the
     returned ID;
  2. the event loop executes ``getfin`` to fetch a completed ID;
  3. the task waiting on that ID is resumed;
  4. the task reads/writes the returned bytes in SPM with synchronous
     :class:`SpmRead`/:class:`SpmWrite` (short, fixed latency — no misses).

Vector commands (:class:`AloadVec`/:class:`AstoreVec` + :class:`AwaitRids`)
issue a whole request vector per generator hop: the scheduler dispatches them
through the engine's ``aload_batch``/``astore_batch`` entry points (true
vector path on `BatchedAsyncMemoryEngine`, scalar-issue loop on the oracle)
and charges ONE amortized issue + ID-batch cost per vector — the §4.2
speculative ID pre-allocation applied at the framework layer. This is what
removes the per-request Python coroutine round-trip from the loop-parallel
workload ports.

:class:`Acquire`/:class:`Release` wrap the software memory-disambiguation set
(Listing 1): conflicting tasks suspend and are resumed in FIFO order when the
owner releases the block.

The scheduler keeps a cycle clock and instruction counter so AMU-mode
execution times / IPC / MLP come out of *actually running* the workloads
against the timed engine — this is what `benchmarks/fig8..fig10` drive.

Cost model (instructions per operation; 6-wide issue, 3 GHz — Table 2):
calibrated constants below; the DMA-mode ablation inflates the per-request
cost exactly where the paper says external engines pay it (descriptor setup,
doorbell, no speculative ID batching).
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Generator, Iterable, Optional

import numpy as np

from repro_torch.core.disambiguation import CuckooAddressSet
from repro_torch.core.engine import LOAD, STORE, AsyncEngineBase


# ---------------------------------------------------------------------- cost
@dataclass(frozen=True)
class CostModel:
    """Per-operation costs, calibrated against Table 4 (AMU ~= baseline at
    0.1 us <=> ~250 core cycles per awaited memory op: coroutine frame
    save/restore + scheduler bookkeeping + getfin loop + SPM (L2) latency)."""
    issue_width: int = 6
    ami_issue_insts: int = 8       # aload/astore + address generation + ID mv
    getfin_insts: int = 8          # poll + dispatch branch
    switch_insts: int = 40         # coroutine suspend+resume instructions
    switch_stall_cycles: float = 100.0  # dependent-chain stalls per switch
    spm_access_cycles: float = 15.0  # L2-latency SPM touch (Table 2)
    spm_byte_cycles: float = 0.25  # per-byte SPM streaming cost (reads the
                                   # DMA'd block out of L2 with dependent ops)
    refill_cycles: float = 20.0    # ALSU<->ASMC list round trip (batched)
    # software disambiguation (Listing 1): cuckoo probe + insert / remove +
    # waiter wakeup. Cache-resident hash tables -> tens of cycles.
    acquire_insts: int = 25
    acquire_stall_cycles: float = 5.0
    release_insts: int = 20
    release_stall_cycles: float = 3.0
    # DMA-mode extras (external-engine ablation: descriptor setup + MMIO
    # doorbell over the NoC, non-speculative issue)
    dma_descriptor_insts: int = 60
    dma_serialize_cycles: float = 180.0
    # vector AMI commands (AloadVec/AstoreVec): the paper's speculative ID
    # pre-allocation means a whole vector pays ONE issue + ID-batch cost
    # (ami_issue_insts, plus refill_cycles per actual list refill) and only a
    # small per-element marginal: address append into the request vector.
    vec_elem_insts: float = 1.5

    def insts_to_cycles(self, insts: float) -> float:
        return insts / self.issue_width


# ------------------------------------------------------------------ commands
@dataclass(frozen=True)
class Aload:
    spm: int
    mem: int
    size: Optional[int] = None


@dataclass(frozen=True)
class Astore:
    spm: int
    mem: int
    size: Optional[int] = None


@dataclass(frozen=True)
class AloadNoWait:
    """Issue an aload and continue executing (returns the request ID to the
    task immediately); pair with AwaitRid to suspend on completion later."""
    spm: int
    mem: int
    size: Optional[int] = None


@dataclass(frozen=True)
class AstoreNoWait:
    spm: int
    mem: int
    size: Optional[int] = None


@dataclass(frozen=True)
class AwaitRid:
    rid: int


@dataclass(frozen=True, eq=False)
class AloadVec:
    """Vectorized aload: issue ``len(spm)`` far->SPM requests as ONE AMI
    vector command (§4.2 metadata batching at the framework level). `spm` and
    `mem` are parallel sequences (lists/tuples/numpy arrays) of SPM offsets
    and far-memory addresses; `size` is the shared granularity (None -> the
    engine's configured granularity). With ``wait=False`` the task resumes
    immediately with a sequence of wait tokens — pair with
    :class:`AwaitRids` to suspend until the whole vector has completed.
    ``wait=True`` fuses the two: the task suspends on the whole vector in
    the same command (identical cost-model charges — AwaitRids itself is
    free and the coroutine switch is charged at completion dispatch — but
    one less host-side generator hop per batch)."""
    spm: object
    mem: object
    size: Optional[int] = None
    wait: bool = False


@dataclass(frozen=True, eq=False)
class AstoreVec:
    """Vectorized astore (SPM -> far memory); see :class:`AloadVec`."""
    spm: object
    mem: object
    size: Optional[int] = None
    wait: bool = False


@dataclass(frozen=True, eq=False)
class AwaitRids:
    """Suspend until EVERY token in `rids` has completed (one coroutine
    resume total — the amortized counterpart of N AwaitRid hops)."""
    rids: tuple


@dataclass(frozen=True)
class Acquire:     # software disambiguation: start_access
    addr: int


@dataclass(frozen=True)
class Release:     # software disambiguation: end_access
    addr: int


@dataclass(frozen=True, eq=False)
class AcquireVec:
    """Vectorized ``start_access`` (§5.1 applied to a pipeline batch):
    acquire EVERY block address in `addrs` in one generator hop — the
    counterpart of :class:`AloadVec` for the lock plane. `addrs` must be
    distinct and ascending (block-deduped total-order locking, see
    ``workloads._lock_set``): acquisition is sequential and on a conflict
    the task suspends in that block's FIFO, resuming acquisition from the
    next address when ownership is handed off. A K-chase batch therefore
    pays ONE coroutine round trip for its whole lock set instead of K
    per-op Acquire hops; the per-block cuckoo probe/insert work is charged
    per element AS each block is attempted — a vector suspended mid-set
    charges its remaining blocks at the hand-off continuation, not upfront
    at the hop (so disambiguation fractions stay comparable to Table 5)."""
    addrs: object


@dataclass(frozen=True, eq=False)
class ReleaseVec:
    """Vectorized ``end_access``: release every block in `addrs` (and hand
    each one's ownership to its head waiter) in one generator hop."""
    addrs: object


@dataclass(frozen=True, eq=False)
class SpmWrite:
    """Synchronous register->SPM store. `data` may be bytes or any
    C-contiguous ndarray (ports hand back computed arrays without a
    `.tobytes()` round trip; the cost model charges the same bytes)."""
    spm: int
    data: object


@dataclass(frozen=True)
class SpmRead:
    """Synchronous SPM->register load. The task receives a READ-ONLY numpy
    view aliasing live SPM (zero-copy): it observes later SpmWrites and DMA
    retirements into its range. Ports that need a snapshot across such an
    overwrite must `.copy()` (or double-buffer their slots); the scalar
    oracle engine asserts on reads racing in-flight loads."""
    spm: int
    size: int


def _nbytes(data) -> int:
    return data.nbytes if isinstance(data, np.ndarray) else len(data)


@dataclass(frozen=True)
class Cost:        # plain compute between memory ops
    insts: float = 0.0
    cycles: float = 0.0


@dataclass(frozen=True)
class WaitUntil:
    """Suspend until the core clock reaches `cycles` (an ABSOLUTE time).

    The open-loop arrival primitive: a serving port sleeps until a
    request's arrival time, then starts its gathers. If the clock is
    already past `cycles` the task continues immediately (the queueing
    delay is real — latency is measured from the scheduled arrival, not
    from the wake). Free of charge: the sleep models the task not
    existing yet, not the core doing work."""
    cycles: float


@dataclass(frozen=True)
class Now:
    """Resume immediately with the current core clock (cycles). Free of
    charge (a cycle-counter register read) — ports use it to timestamp
    request completions for per-request latency accounting."""
    pass


Task = Generator  # yields commands, receives command results


class DeadlockError(RuntimeError):
    pass


class Scheduler:
    def __init__(self, engine: AsyncEngineBase,
                 cost: CostModel = CostModel(),
                 disambiguator: Optional[CuckooAddressSet] = None,
                 dma_mode: bool = False,
                 retry=None):
        self.engine = engine
        self.cost = cost
        self.disamb = disambiguator
        self.dma_mode = dma_mode
        # ---- fault/recovery plane (§3.2 status + RetryPolicy) -------------
        # `retry` duck-types amu.config.RetryPolicy (max_retries/backoff).
        # All of this is dead weight on the zero-fault path: `_fault` is
        # False, every hook below is gated on it, and the run loops only
        # touch `_retry_heap` through truthiness checks on an empty list —
        # so fault-free traces/costs are bit-identical to pre-fault builds.
        self.retry = retry
        self._fault = bool(getattr(engine, "fault_enabled", False))
        self._rp_active = retry is not None and self._fault
        self._tok_req: Dict[int, list] = {}   # tok -> [kind,spm,mem,size,
        #                                        attempt, failover state 0/1/2]
        self._retry_heap: list = []           # (ready_cycles, seq, tok)
        self._retry_seq = 0
        self._tok_fstat: Dict[int, int] = {}  # tok -> final non-OK status
        self._group_toks: Dict[int, tuple] = {}  # id(task) -> awaited toks
        self.n_retries = 0
        self.n_failovers = 0
        self.n_failed = 0
        self.t = 0.0                       # core clock, cycles
        self.insts = 0.0                   # retired instructions
        self.disamb_cycles = 0.0           # time inside start/end_access
        self._ready: Deque[Task] = deque()
        self._alloc_parked: Deque[tuple] = deque()  # (task, command)
        self._results: Dict[int, object] = {}       # id(task) -> pending send
        # request IDs recycle after getfin, so the scheduler tracks each issue
        # with a unique token: rid -> token while in flight, and tasks wait
        # on tokens.
        self._tok = 0
        self._rid_tok: Dict[int, int] = {}
        self._waiting_tok: Dict[int, Task] = {}
        self._unclaimed: set = set()                # completed tokens, no waiter
        # vector-command state: tokens already issued for a parked vector
        # (id(task) -> list), and AwaitRids countdowns (id(task) -> remaining)
        self._vec_acc: Dict[int, list] = {}
        self._wait_count: Dict[int, int] = {}
        # AcquireVec continuations: id(task) -> (addrs, index suspended at)
        self._acq_state: Dict[int, tuple] = {}
        # wake planning (scalar oracle): token -> done time, a heap of
        # group-ready times (each waiting task resumes exactly when the
        # LAST of its tokens completes), and exact heap deletion via
        # dead-mark counts — a live group's wake may sit at or below the
        # clock when the finished backlog lags, so popping by `<= t` (the
        # BatchScheduler shortcut) would mistake it for dispatched here.
        self._tok_time: Dict[int, float] = {}
        self._wake_heap: list = []
        self._wake_dead: Dict[float, int] = {}
        self._wait_wake: Dict[int, float] = {}   # id(task) -> its group wake
        # open-loop sleepers: (wake_cycles, seq, task) heap; tasks suspended
        # on WaitUntil wake (FIFO within a tick via seq) once t >= wake
        self._sleeping: list = []
        self._sleep_seq = 0
        self._live = 0
        # AmuConfig(sanitize=True) shadow-state checker (sessions attach
        # it); None = every hook is skipped, bit-identical to pre-sanitizer
        self._san = None

    # --------------------------------------------------------------- helpers
    def _tick_insts(self, insts: float) -> None:
        self.insts += insts
        self.t += self.cost.insts_to_cycles(insts)

    def _sleep_until(self, task: Task, wake: float) -> None:
        """Park `task` until the clock reaches `wake` (WaitUntil). A wake
        at or below the clock requeues immediately — the arrival is in the
        past, the queueing delay is already being paid."""
        if wake <= self.t:
            self._ready.append(task)
        else:
            self._sleep_seq += 1
            heapq.heappush(self._sleeping, (wake, self._sleep_seq, task))

    def _wake_sleepers(self) -> None:
        """Move every sleeper whose wake time has arrived to the ready
        queue (in wake order, FIFO within a tick)."""
        while self._sleeping and self._sleeping[0][0] <= self.t:
            _, _, task = heapq.heappop(self._sleeping)
            self._ready.append(task)

    def _earliest_sleep(self) -> Optional[float]:
        """Earliest future event the runtime loop itself must service: a
        WaitUntil sleeper or a backoff-delayed retry slot. Both cap every
        clock jump/drain window the same way — the loop top requeues due
        sleepers (`_wake_sleepers`) and re-issues due retries
        (`_service_retries`) from exactly that instant."""
        s = self._sleeping[0][0] if self._sleeping else None
        if self._retry_heap:
            r = self._retry_heap[0][0]
            return r if s is None else min(s, r)
        return s

    # Token bookkeeping hooks — dict-based here (the oracle); BatchScheduler
    # overrides them with preallocated numpy maps for vectorized dispatch.
    def _new_token(self, rid: int) -> int:
        self._tok += 1
        self._rid_tok[rid] = self._tok
        self._tok_time[self._tok] = self.engine.done_time(rid)
        return self._tok

    def _new_tokens(self, rids) -> list:
        """Batch token mint for a successful vector issue (rids all != 0)."""
        return [self._new_token(int(rid)) for rid in rids]

    def _waiting_count(self) -> int:
        return len(self._waiting_tok)

    def _await_tokens(self, task: Task, toks) -> None:
        """Suspend `task` until every token in `toks` completes (tokens that
        already completed unclaimed are consumed immediately)."""
        if self._san is not None:
            self._san.on_await(toks)
        if self._fault:
            self._group_toks[id(task)] = tuple(int(t) for t in toks)
        remaining = 0
        wake = 0.0
        for tok in toks:
            if tok in self._unclaimed:
                self._unclaimed.discard(tok)
            else:
                self._waiting_tok[tok] = task
                wake = max(wake, self._tok_time[tok])
                remaining += 1
        if remaining:
            self._wait_count[id(task)] = remaining
            self._wait_wake[id(task)] = wake
            heapq.heappush(self._wake_heap, wake)
        else:
            if self._fault:
                self._deliver_status(task)
            self._ready.append(task)

    def _issue(self, task: Task, cmd) -> None:
        """Execute an Aload/Astore[-NoWait] or vector issue command."""
        if isinstance(cmd, (AloadVec, AstoreVec)):
            return self._issue_vec(task, cmd)
        c = self.cost
        self._tick_insts(c.ami_issue_insts)
        if self.dma_mode:
            self._tick_insts(c.dma_descriptor_insts)
            self.t += c.dma_serialize_cycles
        self.engine.advance(self.t)
        refills = self.engine.stats["free_refills"]
        if isinstance(cmd, (Aload, AloadNoWait)):
            rid = self.engine.aload(cmd.spm, cmd.mem, cmd.size)
        else:
            rid = self.engine.astore(cmd.spm, cmd.mem, cmd.size)
        if self.engine.stats["free_refills"] != refills:
            self.t += c.refill_cycles      # batched ID fetch round trip
        if rid == 0:
            self._alloc_parked.append((task, cmd))  # queue full: retry later
            return
        tok = self._new_token(rid)
        if self._rp_active:
            kind = LOAD if isinstance(cmd, (Aload, AloadNoWait)) else STORE
            self._tok_req[tok] = [kind, cmd.spm, cmd.mem, cmd.size, 0, 0]
        if isinstance(cmd, (AloadNoWait, AstoreNoWait)):
            self._results[id(task)] = tok        # token back, keep running
            self._ready.append(task)
        else:
            self._await_tokens(task, (tok,))

    def _issue_vec(self, task: Task, cmd) -> None:
        """Execute an AloadVec/AstoreVec for `task`: one amortized issue cost,
        one engine batch call. If the ID pool exhausts mid-vector, the
        remainder parks (retried as completions free IDs) and the task only
        resumes once every element has been issued."""
        c = self.cost
        n = len(cmd.spm)
        acc = self._vec_acc.pop(id(task), [])
        if n == 0:
            self._results[id(task)] = tuple(acc)
            self._ready.append(task)
            return
        # speculative ID pre-allocation: one issue + ID-batch cost per vector
        self._tick_insts(c.ami_issue_insts + c.vec_elem_insts * n)
        if self.dma_mode:
            # external engines pay descriptor setup + doorbell per request
            self._tick_insts(c.dma_descriptor_insts * n)
            self.t += c.dma_serialize_cycles * n
        self.engine.advance(self.t)
        refills = self.engine.stats["free_refills"]
        if isinstance(cmd, AloadVec):
            rids = self.engine.aload_batch(cmd.spm, cmd.mem, cmd.size)
        else:
            rids = self.engine.astore_batch(cmd.spm, cmd.mem, cmd.size)
        self.t += c.refill_cycles * (self.engine.stats["free_refills"] - refills)
        # allocation fails as a zero suffix: full when the last rid is live
        k = n if rids[n - 1] else int(np.count_nonzero(rids))
        toks = self._new_tokens(rids[:k]) if k else []
        if self._rp_active and k:
            self._record_vec_reqs(cmd, toks, k)
        if k < n:
            acc.extend(toks)
            rest = type(cmd)(cmd.spm[k:], cmd.mem[k:], cmd.size, cmd.wait)
            self._vec_acc[id(task)] = acc
            self._alloc_parked.append((task, rest))
            return
        if acc:                             # parked earlier: stitch the tail
            acc.extend(toks)
            toks = tuple(acc)
        if cmd.wait:                        # fused await: suspend in place
            self._await_tokens(task, toks)
        else:                               # tokens straight through (ndarray
            self._results[id(task)] = toks  # on the batch scheduler, list on
            self._ready.append(task)        # the oracle)

    def _record_vec_reqs(self, cmd, toks, k: int) -> None:
        """Retry-plane bookkeeping for a vector issue: remember each lane's
        (kind, spm, mem, size) so a failed lane can be re-issued verbatim.
        Fault-mode-only cost, charged nothing on the clock."""
        kind = LOAD if isinstance(cmd, AloadVec) else STORE
        spm, mem, size = cmd.spm, cmd.mem, cmd.size
        req = self._tok_req
        for i, tok in enumerate(toks):
            req[int(tok)] = [kind, int(spm[i]), int(mem[i]), size, 0, 0]

    def _run_task(self, task: Task, send_value=None) -> None:
        """Resume `task`, process the command it yields (if not finished)."""
        c = self.cost
        try:
            cmd = task.send(send_value)
        except StopIteration:
            self._live -= 1
            return
        if isinstance(cmd, (Aload, Astore, AloadNoWait, AstoreNoWait,
                            AloadVec, AstoreVec)):
            self._issue(task, cmd)
        elif isinstance(cmd, SpmRead):
            self.t += c.spm_access_cycles + c.spm_byte_cycles * cmd.size
            self._tick_insts(1 + cmd.size // 8)
            self._results[id(task)] = self.engine.spm_read(cmd.spm, cmd.size)
            self._ready.append(task)
        elif isinstance(cmd, Cost):
            self._tick_insts(cmd.insts)
            self.t += cmd.cycles
            self._ready.append(task)
        elif isinstance(cmd, WaitUntil):
            self._sleep_until(task, float(cmd.cycles))
        elif isinstance(cmd, Now):
            self._results[id(task)] = self.t
            self._ready.append(task)
        elif isinstance(cmd, AwaitRid):
            self._await_tokens(task, (cmd.rid,))  # cmd.rid is the issue token
        elif isinstance(cmd, AwaitRids):
            self._await_tokens(task, cmd.rids)
        elif isinstance(cmd, SpmWrite):
            nbytes = _nbytes(cmd.data)
            self.t += c.spm_access_cycles + c.spm_byte_cycles * nbytes
            self._tick_insts(1 + nbytes // 8)
            self.engine.spm_write(cmd.spm, cmd.data)
            self._ready.append(task)
        elif isinstance(cmd, Acquire):
            assert self.disamb is not None, "no disambiguator configured"
            if self._san is not None:
                self._san.on_acquire(id(task), (cmd.addr,))
            t0 = self.t
            self._tick_insts(c.acquire_insts)  # hash + probe (Listing 1 l.7)
            self.t += c.acquire_stall_cycles
            ok = self.disamb.start_access(cmd.addr, waiter=task)
            self.disamb_cycles += self.t - t0
            if ok:
                self._ready.append(task)
            # else: suspended; Release will requeue it
        elif isinstance(cmd, Release):
            assert self.disamb is not None
            if self._san is not None:
                self._san.on_release(id(task), (cmd.addr,))
            t0 = self.t
            self._tick_insts(c.release_insts)
            self.t += c.release_stall_cycles
            waiter = self.disamb.end_access(cmd.addr)
            self.disamb_cycles += self.t - t0
            if waiter is not None:
                self._grant(waiter)
            self._ready.append(task)
        elif isinstance(cmd, AcquireVec):
            assert self.disamb is not None, "no disambiguator configured"
            addrs = [int(a) for a in cmd.addrs]
            if self._san is not None:
                self._san.on_acquire(id(task), addrs, vec=True)
            # one hop for the whole lock set; the per-block cuckoo
            # probe/insert work is charged inside _acquire_from as each
            # block is actually attempted — the prefix up to a conflict
            # now, the remainder on the hand-off continuation — so
            # disambiguation fractions attribute the work to the moment
            # it happens (Table 5 comparability for vector ports)
            self._acquire_from(task, addrs, 0)
        elif isinstance(cmd, ReleaseVec):
            assert self.disamb is not None
            addrs = [int(a) for a in cmd.addrs]
            if self._san is not None:
                self._san.on_release(id(task), addrs)
            t0 = self.t
            self._tick_insts(c.release_insts * len(addrs))
            self.t += c.release_stall_cycles * len(addrs)
            self.disamb_cycles += self.t - t0
            for a in addrs:
                waiter = self.disamb.end_access(a)
                if waiter is not None:
                    self._grant(waiter)
            self._ready.append(task)
        else:
            raise TypeError(f"unknown command {cmd!r}")

    def _acquire_from(self, task: Task, addrs, i: int) -> None:
        """Acquire ``addrs[i:]`` in order for `task`, charging each block's
        cuckoo probe/insert as it is attempted (a failed probe is still a
        probe). On a conflict the task is already enqueued in that block's
        waiter FIFO; remember where it stopped so the Release hand-off can
        continue the acquisition — the remaining blocks' charges then land
        at continuation time, not upfront at the AcquireVec hop."""
        c = self.cost
        n = len(addrs)
        while i < n:
            t0 = self.t
            self._tick_insts(c.acquire_insts)
            self.t += c.acquire_stall_cycles
            self.disamb_cycles += self.t - t0
            if not self.disamb.start_access(addrs[i], waiter=task):
                self._acq_state[id(task)] = (addrs, i)
                return
            i += 1
        self._ready.append(task)

    def _grant(self, waiter: Task) -> None:
        """A Release handed `waiter` ownership of the released block: resume
        it — or, if it was suspended mid-:class:`AcquireVec`, continue
        acquiring its remaining addresses (the block it waited on is now
        owned via the hand-off)."""
        st = self._acq_state.pop(id(waiter), None)
        if st is None:
            self._ready.append(waiter)
        else:
            addrs, i = st
            self._acquire_from(waiter, addrs, i + 1)

    def _dispatch_fin(self, rid: int) -> None:
        """Route a completed request ID to its awaiting task (if any). A task
        suspended on AwaitRids only resumes — and only pays the coroutine
        switch once — when its LAST outstanding token completes.

        In fault mode the completion carries a status (`engine.fin_status`,
        set by the getfin that produced `rid`): a failed completion first
        consults the RetryPolicy — the token stays pending while its request
        is re-issued — and only a final (retry-exhausted, failover-failed)
        status reaches the awaiting task."""
        if self._fault:
            status = self.engine.fin_status
            if status:
                tok = self._rid_tok.pop(rid)
                if self._rp_active and self._schedule_retry(tok, status):
                    return               # re-issue pending: token stays live
                self._mark_failed(tok, status)
                self._tok_time.pop(tok, None)
                self._complete_token(tok)
                return
        tok = self._rid_tok.pop(rid)
        if self._rp_active:
            self._tok_req.pop(tok, None)
        self._tok_time.pop(tok, None)
        self._complete_token(tok)

    def _complete_token(self, tok: int) -> None:
        """Final-completion half of dispatch: group countdown, exact wake
        deletion, status delivery (fault mode) and the coroutine switch."""
        task = self._waiting_tok.pop(tok, None)
        if task is None:
            self._unclaimed.add(tok)
            return
        cnt = self._wait_count.get(id(task))
        if cnt is not None:
            if cnt > 1:
                self._wait_count[id(task)] = cnt - 1
                return                       # still waiting on more tokens
            del self._wait_count[id(task)]
        wake = self._wait_wake.pop(id(task), None)
        if wake is not None:                 # exact heap deletion (see init)
            self._wake_dead[wake] = self._wake_dead.get(wake, 0) + 1
        if self._fault:
            self._deliver_status(task)
        self._tick_insts(self.cost.switch_insts)  # resume the awaiter
        self.t += self.cost.switch_stall_cycles
        self._ready.append(task)

    # ------------------------------------------------- fault/recovery plane
    def _deliver_status(self, task: Task) -> None:
        """Hand the resuming task its per-lane statuses as the await's send
        value: an int for single-token awaits, an int8 array (lane-aligned)
        for vector awaits. 0/all-zero means every lane succeeded."""
        toks = self._group_toks.pop(id(task), None)
        if toks is None:
            return                       # not an await resume (issue/SPM/...)
        fst = self._tok_fstat
        if len(toks) == 1:
            self._results[id(task)] = fst.pop(toks[0], 0)
        else:
            self._results[id(task)] = np.array(
                [fst.pop(t, 0) for t in toks], np.int8)

    def _mark_failed(self, tok: int, status: int) -> None:
        """Record a token's FINAL failure status (delivered to its awaiter)."""
        self._tok_fstat[tok] = int(status)
        self.n_failed += 1
        if self._rp_active:
            self._tok_req.pop(tok, None)

    def _schedule_retry(self, tok: int, status: int) -> bool:
        """Decide recovery for a failed completion. Returns True when a
        re-issue (retry with exponential backoff, or a one-shot failover to
        the region's configured alternate) was scheduled — the token stays
        pending and its awaiting task keeps waiting. False means the failure
        is final."""
        req = self._tok_req.get(tok)
        if req is None:
            return False
        rp = self.retry
        if req[4] < rp.max_retries:
            delay = rp.backoff * (2.0 ** req[4])
            req[4] += 1
        elif req[5] == 0 and \
                self.engine.far.failover_index(req[2]) is not None:
            # retries exhausted on the home path: one failover attempt
            # through the region's configured alternate (same far-memory
            # address — an alternate path/replica, so the data plane is
            # unchanged; only the timing/fault draws route differently)
            delay = rp.backoff * (2.0 ** req[4])
            req[5] = 1
        else:
            return False
        self._retry_seq += 1
        heapq.heappush(self._retry_heap,
                       (self.t + delay, self._retry_seq, tok))
        return True

    def _rebind_token(self, tok: int, rid: int) -> None:
        """Point an existing (still-awaited) token at its re-issued rid."""
        self._rid_tok[rid] = tok
        self._tok_time[tok] = self.engine.done_time(rid)

    def _service_retries(self) -> None:
        """Re-issue every retry whose backoff slot has arrived (loop-top
        hook, the retry counterpart of `_wake_sleepers`). The re-issue pays
        the normal AMI issue cost and enters the far model like any other
        request — retry traffic is charged to the ledger honestly. If the
        ID pool is exhausted the slot is pushed back and re-attempted next
        turn (completions free IDs each turn)."""
        heap = self._retry_heap
        c = self.cost
        while heap and heap[0][0] <= self.t:
            _, _, tok = heapq.heappop(heap)
            req = self._tok_req[tok]
            kind, spm, mem, size = req[0], req[1], req[2], req[3]
            self._tick_insts(c.ami_issue_insts)
            self.engine.advance(self.t)
            far = self.engine.far
            refills = self.engine.stats["free_refills"]
            forced = req[5] == 1
            if forced:
                far._forced_region = far.failover_index(mem)
            try:
                if kind == LOAD:
                    rid = self.engine.aload(spm, mem, size)
                else:
                    rid = self.engine.astore(spm, mem, size)
            finally:
                if forced:
                    far._forced_region = None
            if self.engine.stats["free_refills"] != refills:
                self.t += c.refill_cycles  # batched ID fetch round trip
            if rid == 0:
                self._retry_seq += 1
                heapq.heappush(heap, (self.t, self._retry_seq, tok))
                return
            if forced:
                req[5] = 2
                self.n_failovers += 1
            else:
                self.n_retries += 1
            self._rebind_token(tok, rid)

    def _idle_until_completion(self) -> None:
        """Nothing runnable: validate liveness and advance to the next
        completion, with exact-wake planning (the BatchScheduler idea,
        scalar-loop-exact): any completion that retires strictly before the
        earliest group-ready time cannot resume a task, so its poll turn is
        replayed here in a tight loop — same per-turn accounting (advance to
        the completion, one getfin charge, dispatch) as the runtime loop,
        bit-for-bit — instead of paying a full loop turn per completion.
        Parked tasks can be unblocked by ANY completion (a freed ID), so
        they force single-stepping; the readying completion itself is left
        to the runtime loop, which polls it and runs the awakened task in
        the same turn, exactly as before. Sleepers (WaitUntil) cap every
        jump/drain window at their earliest wake: a waking sleeper issues
        new requests from that instant, so the clock must not overshoot
        it."""
        if not (self._waiting_count() or self._alloc_parked
                or self._sleeping or self._retry_heap):
            raise DeadlockError("live tasks but none ready/waiting")
        c = self.cost
        sleep0 = self._earliest_sleep()
        heap = self._wake_heap
        dead = self._wake_dead
        while heap and dead.get(heap[0]):  # exact lazy deletion
            if dead[heap[0]] == 1:
                del dead[heap[0]]
            else:
                dead[heap[0]] -= 1
            heapq.heappop(heap)
        # heap[0] (if any) is now a LIVE group's wake; when it already sits
        # at/below the clock its final token waits in the finished backlog,
        # so only a strictly-future wake opens the drain window
        if heap and not self._alloc_parked:
            wake = heap[0] if sleep0 is None else min(heap[0], sleep0)
            while wake > self.t:
                next_done = self.engine.next_completion_time
                # retirement happens at max(t, next_done): only provably
                # pre-wake turns (every retired token non-final) drain here
                if next_done is None or max(self.t, next_done) >= wake:
                    break
                self.t = max(self.t, next_done)
                self.engine.advance(self.t)
                self._tick_insts(c.getfin_insts)
                rid = self.engine.getfin()
                if rid:
                    self._dispatch_fin(rid)
        next_done = self.engine.next_completion_time
        if next_done is None:
            if self.engine.finished_pending:
                return                     # drain via getfin next round
            if sleep0 is not None:         # nothing in flight: jump to the
                self.t = max(self.t, sleep0)   # next arrival
                self.engine.advance(self.t)
                return
            raise DeadlockError(
                f"{self._waiting_count()} waiting, "
                f"{len(self._alloc_parked)} parked, none outstanding")
        if sleep0 is not None:
            next_done = min(next_done, sleep0)
        self.t = max(self.t, next_done)
        self.engine.advance(self.t)

    # ------------------------------------------------------------------ API
    def spawn(self, task: Task) -> None:
        self._live += 1
        self._ready.append(task)

    @property
    def live(self) -> int:
        """Spawned tasks that have not finished (the rack arbiter polls
        this to know when a core's port is done)."""
        return self._live

    def step(self) -> None:
        """One runtime-loop turn: wake sleepers, service retries, poll one
        completion, run one ready task (or idle to the next completion).
        :meth:`run` is exactly `while live: step()` — an external arbiter
        (``repro_torch.core.rack``) interleaving `step()` calls across schedulers
        reproduces each scheduler's solo execution bit-for-bit."""
        c = self.cost
        if self._sleeping:             # arrivals whose time has come
            self._wake_sleepers()
        if self._retry_heap:           # backoff slots whose time has come
            self._service_retries()
        # event loop: poll completions first (Fig 4 step 3)
        if (self._waiting_count() or self._alloc_parked
                or self.engine.outstanding or self.engine.finished_pending):
            self.engine.advance(self.t)
            self._tick_insts(c.getfin_insts)
            rid = self.engine.getfin()
            if rid:
                self._dispatch_fin(rid)
                # freed an ID: a parked task can retry its issue
                if self._alloc_parked:
                    ptask, pcmd = self._alloc_parked.popleft()
                    self._issue(ptask, pcmd)
        if self._ready:
            task = self._ready.popleft()
            self._run_task(task, self._results.pop(id(task), None))
        elif self._live > 0:
            self._idle_until_completion()

    def run(self, tasks: Optional[Iterable[Task]] = None) -> dict:
        """Drive all tasks to completion; returns timing/throughput stats."""
        for task in tasks or ():
            self.spawn(task)
        while self._live > 0:
            self.step()
        return self.summary()

    def summary(self) -> dict:
        far = self.engine.far
        out = {
            "cycles": self.t,
            "insts": self.insts,
            "ipc": self.insts / max(self.t, 1e-9),
            "mlp": far.avg_mlp(self.t),
            "requests": far.requests,
            "bytes": far.bytes_moved,
            "disamb_cycles": self.disamb_cycles,
            "disamb_frac": self.disamb_cycles / max(self.t, 1e-9),
        }
        if self._fault:
            # logical requests = far-model entries minus recovery re-issues;
            # availability = fraction of logical requests that ultimately
            # succeeded (possibly after retries/failover)
            logical = far.requests - self.n_retries - self.n_failovers
            out["faults_injected"] = far.faults_injected
            out["retries"] = self.n_retries
            out["timeouts"] = far.timeouts
            out["failovers"] = self.n_failovers
            out["failed"] = self.n_failed
            out["availability"] = 1.0 - self.n_failed / max(logical, 1)
        return out

    def reset_stats(self) -> None:
        """Zero the recovery-plane counters and drop any in-flight retry
        state — the scheduler-side counterpart of
        :meth:`FarMemoryModel.reset_stats` for a prepare/measure split.
        Pending backoff slots are abandoned (their requests were warmup
        traffic); tokens already awaited stay resolvable via the engine."""
        self.n_retries = 0
        self.n_failovers = 0
        self.n_failed = 0
        self._retry_heap.clear()
        self._tok_req.clear()
        self._tok_fstat.clear()
        self._group_toks.clear()


class BatchScheduler(Scheduler):
    """Batch-stepped runtime loop (§4.2 metadata batching applied to the host
    model): each *epoch* drains ALL currently-finished IDs in one
    ``getfin_all`` sweep, resumes every awaiter, then steps every ready task
    once — instead of one getfin + one task step per loop turn.

    Semantics (what data lands where, FIFO disambiguation hand-off, parked
    retry on ID exhaustion, deadlock detection) match :class:`Scheduler`;
    only the interleaving — and therefore the Python-level driver overhead —
    differs. Works with either engine; `BatchedAsyncMemoryEngine.getfin_all`
    makes the drain itself a vectorized operation.

    Token routing is a numpy data plane rather than the oracle's dicts: a
    preallocated ``rid -> token`` array, growable ``token -> waiter-group``
    / ``token -> completed-unclaimed`` maps, and per-group outstanding
    counters. :meth:`_dispatch_fins` retires a whole getfin_all epoch in a
    handful of numpy ops (gather tokens, gather groups, scatter-subtract
    counters, find the groups that hit zero) instead of per-rid dict pops —
    the §4.2 metadata-batching idea applied to completion dispatch itself.
    """

    _GROW = 1024

    def __init__(self, engine: AsyncEngineBase,
                 cost: CostModel = CostModel(),
                 disambiguator: Optional[CuckooAddressSet] = None,
                 dma_mode: bool = False,
                 retry=None):
        super().__init__(engine, cost, disambiguator, dma_mode, retry)
        # rid -> token map (slot 0 unused; rids are 1-based)
        self._rid_tok = np.zeros(engine.config.queue_length + 1, np.int64)
        # token-indexed maps (slot 0 unused; tokens are 1-based)
        self._tok_group = np.full(self._GROW, -1, np.int64)
        self._tok_done = np.zeros(self._GROW, bool)
        self._tok_time = np.zeros(self._GROW, np.float64)
        # waiter groups: one per suspended task; counters hit 0 -> resume
        self._group_task: list = []
        self._group_left = np.zeros(self._GROW, np.int64)
        self._n_wait_groups = 0
        self._n_unclaimed = 0            # completed tokens nobody awaits yet
        # wake planning: each waiting group readies exactly when its LAST
        # token completes; the idle path jumps the clock straight there
        # instead of crawling one completion (= one empty epoch) at a time
        self._wake_heap: list = []

    # ------------------------------------------------- token plumbing hooks
    def _grow_tok_maps(self) -> None:
        grow = max(self._tok_group.size, self._tok + self._GROW)
        self._tok_group = np.concatenate(
            [self._tok_group, np.full(grow, -1, np.int64)])
        self._tok_done = np.concatenate(
            [self._tok_done, np.zeros(grow, bool)])
        self._tok_time = np.concatenate(
            [self._tok_time, np.zeros(grow, np.float64)])

    def _new_token(self, rid: int) -> int:
        self._tok += 1
        tok = self._tok
        if rid >= self._rid_tok.size:            # queue_length was resized up
            self._rid_tok = np.concatenate(
                [self._rid_tok, np.zeros(rid + 1 - self._rid_tok.size,
                                         np.int64)])
        self._rid_tok[rid] = tok
        if tok >= self._tok_group.size:
            self._grow_tok_maps()
        self._tok_group[tok] = -1
        self._tok_time[tok] = self.engine.done_time(rid)
        return tok

    def _new_tokens(self, rids) -> list:
        """Vectorized token mint: tokens are sequential, so a whole vector
        issue is a handful of fancy-index stores instead of a per-rid loop."""
        k = len(rids)
        toks = np.arange(self._tok + 1, self._tok + k + 1)
        self._tok += k
        if self._tok >= self._tok_group.size:
            self._grow_tok_maps()
        rids = np.asarray(rids, np.int64)
        if self._rid_tok.size <= self.engine.config.queue_length \
                and int(rids.max()) >= self._rid_tok.size:  # resized up
            self._rid_tok = np.concatenate(
                [self._rid_tok, np.zeros(int(rids.max()) + 1
                                         - self._rid_tok.size, np.int64)])
        self._rid_tok[rids] = toks
        self._tok_group[toks] = -1
        self._tok_time[toks] = self.engine.done_times(rids)
        return toks

    def _waiting_count(self) -> int:
        return self._n_wait_groups

    # Token maps grow with every token ever minted. At quiesce points — no
    # request in flight, no waiter, no unclaimed completion, nothing parked,
    # so no live token reference can exist — the maps recycle, keeping
    # resident memory bounded by the busiest in-flight window instead of
    # the total request count of a long sweep.
    _RECYCLE_AT = 1 << 16

    def _maybe_recycle_tokens(self) -> None:
        if (self._tok < self._RECYCLE_AT or self._n_wait_groups
                or self._n_unclaimed or self._alloc_parked
                or self._retry_heap or self.engine.active_requests):
            return
        self._tok = 0
        self._tok_group = np.full(self._GROW, -1, np.int64)
        self._tok_done = np.zeros(self._GROW, bool)
        self._tok_time = np.zeros(self._GROW, np.float64)
        self._group_task = []
        self._group_left = np.zeros(self._GROW, np.int64)
        self._wake_heap.clear()          # all entries are <= now: stale
        if self._fault:
            # token numbers restart: drop bookkeeping keyed by old tokens
            # (all final — no waiter/retry/unclaimed state exists here)
            self._tok_req.clear()
            self._tok_fstat.clear()
            self._group_toks.clear()
        if self._san is not None:
            self._san.on_token_recycle()

    def _idle_until_completion(self) -> None:
        """Idle step with wake planning: nothing is runnable, so no new
        issues can occur before some waiter resumes — it is therefore safe
        (and exact) to jump the clock to the earliest group-ready time (the
        max done-time of that group's tokens) instead of crawling one
        completion per epoch. With tasks parked on ID exhaustion, any single
        completion can unblock them, so fall back to single-stepping.
        Sleepers (WaitUntil) cap the jump at their earliest wake — a waking
        arrival issues new requests from that instant."""
        if not (self._n_wait_groups or self._alloc_parked or self._sleeping
                or self._retry_heap):
            raise DeadlockError("live tasks but none ready/waiting")
        sleep0 = self._earliest_sleep()
        next_done = self.engine.next_completion_time
        if next_done is None:
            if self.engine.finished_pending:
                return                     # drain via getfin next round
            if sleep0 is not None:         # nothing in flight: jump to the
                self.t = max(self.t, sleep0)   # next arrival
                self.engine.advance(self.t)
                return
            raise DeadlockError(
                f"{self._n_wait_groups} waiting, "
                f"{len(self._alloc_parked)} parked, none outstanding")
        heap = self._wake_heap
        while heap and heap[0] <= self.t:  # groups already dispatched
            heapq.heappop(heap)
        if self._alloc_parked or not heap:
            target = next_done
        else:
            target = heap[0]
        if sleep0 is not None:
            target = min(target, sleep0)
        self.t = max(self.t, target)
        self.engine.advance(self.t)

    def _new_group(self, task: Task, count: int, wake_time: float) -> int:
        """Register a waiter group: `task` resumes when `count` of its
        tokens complete, which wake planning knows happens at `wake_time`."""
        gid = len(self._group_task)
        self._group_task.append(task)
        if gid >= self._group_left.size:
            self._group_left = np.concatenate(
                [self._group_left,
                 np.zeros(max(self._group_left.size, self._GROW), np.int64)])
        self._group_left[gid] = count
        self._n_wait_groups += 1
        heapq.heappush(self._wake_heap, wake_time)
        return gid

    def _await_tokens(self, task: Task, toks) -> None:
        if self._san is not None:
            self._san.on_await(toks)
        if self._fault:
            self._group_toks[id(task)] = tuple(int(t) for t in toks)
        if len(toks) == 1:                       # AwaitRid / awaited scalar
            tok = toks[0]                        # issue: skip array overhead
            if self._tok_done[tok]:
                self._tok_done[tok] = False
                self._n_unclaimed -= 1
                if self._fault:
                    self._deliver_status(task)
                self._ready.append(task)
                return
            self._tok_group[tok] = self._new_group(
                task, 1, float(self._tok_time[tok]))
            return
        toks = np.asarray(toks, np.int64)
        if toks.size == 0:
            if self._fault:
                self._deliver_status(task)
            self._ready.append(task)
            return
        done = self._tok_done[toks]
        ds = int(done.sum())
        if ds == toks.size:
            self._tok_done[toks] = False         # consume unclaimed tokens
            self._n_unclaimed -= toks.size
            if self._fault:
                self._deliver_status(task)
            self._ready.append(task)
            return
        if ds:
            self._tok_done[toks[done]] = False
            self._n_unclaimed -= ds
            pending = toks[~done]
        else:
            pending = toks                       # common case: none done yet
        self._tok_group[pending] = self._new_group(
            task, pending.size, float(self._tok_time[pending].max()))

    def _dispatch_fins(self, rids) -> None:
        """Vectorized bulk dispatch: route a whole epoch of completed IDs to
        their waiter groups in O(few numpy ops). Tasks resume in the same
        order the oracle's per-rid loop would produce (a group becomes ready
        exactly where its LAST outstanding token sits in `rids`); the switch
        costs are summed into one clock update, as before."""
        if not rids:
            return
        if self._fault:
            sts = self.engine.fin_statuses
            if any(sts):
                # some completion failed: fall back to a per-rid ordered
                # loop (retry/failover scheduling + final-status routing).
                # Shared by BatchScheduler and EpochScheduler, so their
                # bit-identity survives fault injection.
                self._dispatch_fins_faulty(rids, sts)
                return
        if len(rids) <= 6:                       # sparse epoch: skip the
            n_ready = 0                          # vector machinery; groups
            for rid in rids:                     # still resume at their last
                tok = self._rid_tok[rid]         # token's position, and the
                gid = self._tok_group[tok]       # switch costs apply as one
                if gid < 0:                      # multiply, like the vector
                    self._tok_done[tok] = True   # path
                    self._n_unclaimed += 1
                    continue
                left = self._group_left[gid] - 1
                self._group_left[gid] = left
                if left == 0:
                    gtask = self._group_task[gid]
                    if self._fault:
                        self._deliver_status(gtask)
                    self._ready.append(gtask)
                    self._group_task[gid] = None
                    n_ready += 1
            if n_ready:
                self._n_wait_groups -= n_ready
                self._tick_insts(self.cost.switch_insts * n_ready)
                self.t += self.cost.switch_stall_cycles * n_ready
            return
        toks = self._rid_tok[np.asarray(rids, np.int64)]
        groups = self._tok_group[toks]
        unclaimed = groups < 0
        if unclaimed.any():
            self._tok_done[toks[unclaimed]] = True
            self._n_unclaimed += int(unclaimed.sum())
            if unclaimed.all():
                return
            groups = groups[~unclaimed]
        mx = int(groups.max()) + 1            # bincount beats subtract.at
        self._group_left[:mx] -= np.bincount(groups, minlength=mx)
        # groups hitting zero, ordered by their last occurrence in the epoch
        uniq, rev_idx = np.unique(groups[::-1], return_index=True)
        ready_mask = self._group_left[uniq] == 0
        n_ready = int(ready_mask.sum())
        if n_ready == 0:
            return
        last_pos = groups.size - 1 - rev_idx[ready_mask]
        for gid in uniq[ready_mask][np.argsort(last_pos, kind="stable")]:
            gtask = self._group_task[gid]
            if self._fault:
                self._deliver_status(gtask)
            self._ready.append(gtask)
            self._group_task[gid] = None
        self._n_wait_groups -= n_ready
        self._tick_insts(self.cost.switch_insts * n_ready)
        self.t += self.cost.switch_stall_cycles * n_ready

    def _dispatch_fins_faulty(self, rids, sts) -> None:
        """Ordered per-rid dispatch for an epoch containing failures: same
        group-countdown/unclaimed semantics as the ≤6-rid scalar path, plus
        retry/failover scheduling and final-status routing. Failed tokens
        whose re-issue is scheduled stay pending (their group does not
        count down)."""
        n_ready = 0
        rp = self._rp_active
        for rid, status in zip(rids, sts):
            tok = int(self._rid_tok[rid])
            if status:
                if rp and self._schedule_retry(tok, status):
                    continue             # token re-issued: group keeps waiting
                self._mark_failed(tok, status)
            elif rp:
                self._tok_req.pop(tok, None)
            gid = self._tok_group[tok]
            if gid < 0:
                self._tok_done[tok] = True
                self._n_unclaimed += 1
                continue
            left = self._group_left[gid] - 1
            self._group_left[gid] = left
            if left == 0:
                gtask = self._group_task[gid]
                self._deliver_status(gtask)
                self._ready.append(gtask)
                self._group_task[gid] = None
                n_ready += 1
        if n_ready:
            self._n_wait_groups -= n_ready
            self._tick_insts(self.cost.switch_insts * n_ready)
            self.t += self.cost.switch_stall_cycles * n_ready

    def _rebind_token(self, tok: int, rid: int) -> None:
        if rid >= self._rid_tok.size:    # queue_length was resized up
            self._rid_tok = np.concatenate(
                [self._rid_tok, np.zeros(rid + 1 - self._rid_tok.size,
                                         np.int64)])
        self._rid_tok[rid] = tok
        done = self.engine.done_time(rid)
        self._tok_time[tok] = done
        # wake planning: the re-issued completion is a lower bound on its
        # group's ready time — cap the idle jump there so the retried fin
        # is drained (and possibly re-retried) the turn it lands
        heapq.heappush(self._wake_heap, float(done))

    def step(self) -> None:
        """One batch-stepped epoch (the `run` loop body, arbiter-steppable)."""
        c = self.cost
        if self._sleeping:             # arrivals whose time has come
            self._wake_sleepers()
        if self._retry_heap:           # backoff slots whose time has come
            self._service_retries()
        if self._tok >= self._RECYCLE_AT:
            self._maybe_recycle_tokens()
        if (self._n_wait_groups or self._alloc_parked
                or self.engine.outstanding or self.engine.finished_pending):
            self.engine.advance(self.t)
            # poll only when the finished list can be non-empty — the
            # batch runtime KNOWS (it just advanced the clock), so
            # epochs between completions skip the drain entirely
            if self.engine.finished_pending:
                rids = self.engine.getfin_all()
                # one poll per retrieved ID + the terminating empty poll
                self._tick_insts(c.getfin_insts * (len(rids) + 1))
                self._dispatch_fins(rids)
                # freed IDs: parked tasks can retry their issues. The
                # retry budget is the engine's free-ID count, read once
                # per epoch: retries stop the moment a retry parks again
                # (pool drained mid-vector), so heavy ID exhaustion
                # costs O(retries), not O(parked^2) re-park churn.
                while self._alloc_parked and self.engine.free_ids:
                    ptask, pcmd = self._alloc_parked.popleft()
                    parked_before = len(self._alloc_parked)
                    self._issue(ptask, pcmd)
                    if len(self._alloc_parked) > parked_before:
                        break
        if self._ready:
            # step every currently-ready task once (snapshot: tasks that
            # re-queue themselves run again next epoch, after the poll)
            for _ in range(len(self._ready)):
                task = self._ready.popleft()
                self._run_task(task, self._results.pop(id(task), None))
        elif self._live > 0:
            self._idle_until_completion()


class EpochScheduler(BatchScheduler):
    """Epoch-fused runtime loop: ONE engine entry per scheduler epoch.

    The BatchScheduler already steps every ready task once per epoch, but
    each port's issue command still crosses the engine surface on its own —
    32 coroutines yielding AloadVec means 32 `aload_batch` calls (and 32
    far-model entries) per epoch. Here those calls only *stage*: the engine
    collects every staged batch into one SoA mega-batch and
    :meth:`~repro_torch.core.engine.BatchedAsyncMemoryEngine.flush_epoch` enters
    the far model once, at the end of the epoch's step phase. The epoch-top
    drain likewise goes through one `getfin_epoch` call.

    What stays at staging time (it observes live state): ID allocation,
    SPM bounds checks, astore payload capture, and every cost-model charge
    (issue insts, DMA descriptors, refill round trips) — so the core clock
    `t` evolves identically to the per-command loop. What defers to the
    flush: the far-model math, AMART scatter, trace rows, token done-times
    (the epoch's tokens are a contiguous range, filled with one vector
    store) and waiter-group registration (replayed in command order).
    The flush ends by advancing the engine to the last staged time, which
    reproduces the cumulative retirement effect of the per-command loop's
    mid-epoch advances. The result is pinned bit-identical — trace,
    summary, stats, RNG bitstreams — to :class:`BatchScheduler` on the
    same engine (tests/test_epoch_fusion.py).

    On an engine without the epoch surface (the scalar oracle) every
    override falls through to the inherited per-command protocol.
    """

    def __init__(self, engine: AsyncEngineBase,
                 cost: CostModel = CostModel(),
                 disambiguator: Optional[CuckooAddressSet] = None,
                 dma_mode: bool = False,
                 retry=None):
        super().__init__(engine, cost, disambiguator, dma_mode, retry)
        self._fuse = bool(getattr(engine, "supports_epoch", False))
        # deferred per-epoch state: tokens minted since the last flush are
        # (_ep_tok_start, _tok]; their done-times land at the flush. Awaits
        # collected during the epoch replay in command order after that.
        self._ep_tok_start = self._tok
        self._ep_awaits: list = []

    # ------------------------------------------------- deferred token mint
    def _new_token(self, rid: int) -> int:
        # an immediate mint (scalar command, after its flush) carries its
        # real done-time already: keep it out of the epoch's deferred window
        # (_ep_tok_start, _tok], whose times are back-filled at the flush
        tok = super()._new_token(rid)
        self._ep_tok_start = self._tok
        return tok

    def _mint_deferred(self, rids) -> np.ndarray:
        """`_new_tokens` minus the done-time gather (filled at the flush)."""
        k = len(rids)
        toks = np.arange(self._tok + 1, self._tok + k + 1)
        self._tok += k
        if self._tok >= self._tok_group.size:
            self._grow_tok_maps()
        rids = np.asarray(rids, np.int64)
        if self._rid_tok.size <= self.engine.config.queue_length \
                and int(rids.max()) >= self._rid_tok.size:  # resized up
            self._rid_tok = np.concatenate(
                [self._rid_tok, np.zeros(int(rids.max()) + 1
                                         - self._rid_tok.size, np.int64)])
        self._rid_tok[rids] = toks
        self._tok_group[toks] = -1
        return toks

    def _maybe_recycle_tokens(self) -> None:
        super()._maybe_recycle_tokens()
        if self._tok == 0:                 # maps recycled (staging is empty
            self._ep_tok_start = 0         # at the loop top, so no live refs)

    def _service_retries(self) -> None:
        # retry re-issues take the immediate scalar engine path: flush any
        # staged epoch first so engine entry order = command order (a no-op
        # at the loop top, where retries are serviced)
        if self._fuse:
            self._flush_epoch()
        super()._service_retries()

    # ---------------------------------------------------- staged issue path
    def _issue(self, task: Task, cmd) -> None:
        if isinstance(cmd, (AloadVec, AstoreVec)):
            return self._issue_vec(task, cmd)
        # scalar commands take the immediate per-command path (staging a
        # 1-row numpy batch costs more host time than it saves); flushing
        # first keeps engine entry order = command order, so the trace and
        # far-model draw sequence stay identical to the per-command loop
        if self._fuse:
            self._flush_epoch()
        return super()._issue(task, cmd)

    def _issue_vec(self, task: Task, cmd) -> None:
        if not self._fuse:
            return super()._issue_vec(task, cmd)
        c = self.cost
        n = len(cmd.spm)
        acc = self._vec_acc.pop(id(task), [])
        if n == 0:
            self._results[id(task)] = tuple(acc)
            self._ready.append(task)
            return
        # speculative ID pre-allocation: one issue + ID-batch cost per vector
        self._tick_insts(c.ami_issue_insts + c.vec_elem_insts * n)
        if self.dma_mode:
            # external engines pay descriptor setup + doorbell per request
            self._tick_insts(c.dma_descriptor_insts * n)
            self.t += c.dma_serialize_cycles * n
        refills = self.engine.stats["free_refills"]
        kind = LOAD if isinstance(cmd, AloadVec) else STORE
        rids = self.engine.stage_epoch(kind, self.t, cmd.spm, cmd.mem,
                                       cmd.size)
        self.t += c.refill_cycles * (self.engine.stats["free_refills"]
                                     - refills)
        # allocation fails as a zero suffix: full when the last rid is live
        k = n if rids[n - 1] else int(np.count_nonzero(rids))
        toks = self._mint_deferred(rids[:k]) if k else []
        if self._rp_active and k:
            self._record_vec_reqs(cmd, toks, k)
        if k < n:
            acc.extend(toks)
            rest = type(cmd)(cmd.spm[k:], cmd.mem[k:], cmd.size, cmd.wait)
            self._vec_acc[id(task)] = acc
            self._alloc_parked.append((task, rest))
            return
        if acc:                             # parked earlier: stitch the tail
            acc.extend(toks)
            toks = tuple(acc)
        if cmd.wait:                        # fused await: suspend at flush
            self._ep_awaits.append((task, toks))
        else:
            self._results[id(task)] = toks
            self._ready.append(task)

    def _flush_epoch(self) -> None:
        """End the epoch: one engine/far entry for everything staged, fill
        the epoch's token done-times with one vector store, then register
        the deferred waiter groups in command order."""
        if not self.engine.epoch_staged and not self._ep_awaits:
            return                          # clean epoch: flush is a no-op
        tok_lo = self._ep_tok_start
        dones = self.engine.flush_epoch()
        if dones.size:
            self._tok_time[tok_lo + 1:tok_lo + 1 + dones.size] = dones
        self._ep_tok_start = self._tok
        if self._ep_awaits:
            awaits, self._ep_awaits = self._ep_awaits, []
            for task, toks in awaits:
                self._await_tokens(task, toks)

    # -------------------------------------------------------- runtime loop
    def step(self) -> None:
        if not self._fuse:
            return super().step()
        c = self.cost
        if self._sleeping:             # arrivals whose time has come
            self._wake_sleepers()
        if self._retry_heap:           # backoff slots whose time has come
            self._service_retries()
        if self._tok >= self._RECYCLE_AT:
            self._maybe_recycle_tokens()
        if (self._n_wait_groups or self._alloc_parked
                or self.engine.outstanding or self.engine.finished_pending):
            # one advance + (iff anything finished) one drain per epoch
            rids = self.engine.getfin_epoch(self.t)
            if rids is not None:
                self._tick_insts(c.getfin_insts * (len(rids) + 1))
                self._dispatch_fins(rids)
                # freed IDs: parked tasks can retry (staged, not issued)
                while self._alloc_parked and self.engine.free_ids:
                    ptask, pcmd = self._alloc_parked.popleft()
                    parked_before = len(self._alloc_parked)
                    self._issue(ptask, pcmd)
                    if len(self._alloc_parked) > parked_before:
                        break
        if self._ready:
            # step every currently-ready task once (snapshot: tasks that
            # re-queue themselves run again next epoch, after the poll)
            for _ in range(len(self._ready)):
                task = self._ready.popleft()
                self._run_task(task, self._results.pop(id(task), None))
            self._flush_epoch()
        elif self._live > 0:
            # a parked retry may have staged a partial vector with no
            # task left ready: flush it before idling on completions
            self._flush_epoch()
            self._idle_until_completion()


SCHEDULER_KINDS = {"scalar": Scheduler, "batched": BatchScheduler,
                   "fused": EpochScheduler}
