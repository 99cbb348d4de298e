"""AsyncMemoryEngine — architectural semantics of AMI (Table 1) + AMU state.

This is the host-side reference model of the paper's contribution:

* ``aload(spm_addr, mem_addr)``  -> request ID (0 == allocation failure)
* ``astore(spm_addr, mem_addr)`` -> request ID (0 == allocation failure)
* ``getfin()``                   -> completed request ID (0 == none finished)
* config registers: ``granularity``, ``queue_base``, ``queue_length``

State mirrors the ASMC's three SPM-resident structures (§4.1): a **free list**,
a **finished list**, and the **AMART** (request table indexed by ID). Data
moves only between the SPM (a byte array standing in for the repurposed L2
slice / Hopper shared-memory slot ring) and far memory; register<->SPM traffic uses
:meth:`spm_read`/:meth:`spm_write` (the synchronous load/store half of the
paper's split).

The engine is *timed*: every request is scheduled on a
:class:`~repro_torch.core.farmem.FarMemoryModel` and completes when the driver
advances the clock past its completion time. With :class:`InstantMemory` it
degenerates to a functional oracle used by the kernel tests.

ID batching (§4.2 metadata batching) is modeled: the ALSU-side list-vector
register caches up to ``batch_ids`` free/finished IDs, so steady-state
aload/getfin touch the (slower) ASMC lists only every ``batch_ids`` calls.
``batch_ids=1`` reproduces the paper's **AMU (DMA-mode)** ablation.

Two implementations share the AMI contract:

* :class:`AsyncMemoryEngine` — the scalar reference ("oracle"): per-event
  heapq, dataclass AMART entries. Kept deliberately simple; every batched
  behaviour is differentially tested against it.
* :class:`BatchedAsyncMemoryEngine` — structure-of-arrays AMART, ring-buffer
  free/finished lists, and vectorized completion retirement. Call-for-call
  **trace-identical** to the scalar engine (same IDs, same done-times, same
  SPM/far-memory bytes, same stats), but adds batch entry points
  (:meth:`aload_batch`, :meth:`astore_batch`, :meth:`getfin_all`) that move
  whole vectors of requests per Python-level call — the §4.2 metadata-batching
  idea applied to the host model itself.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import EngineConfig
from repro_torch.core.farmem import FarMemoryModel, InstantMemory

AMART_ENTRY_BYTES = 16   # §3.2: SPM addr, mem addr, status, impl. bits
LOAD, STORE = 0, 1


def format_race(where: str, what: str, lo: int, hi: int, rid: int,
                w_lo: int, w_hi: int, port: str = "") -> str:
    """Shared diagnostic for SPM-vs-in-flight-DMA races: used by the scalar
    oracle's assertion and by the runtime sanitizer, so the message shape
    is identical no matter which engine caught the race."""
    who = f"rid={rid}" + (f" (port {port!r})" if port else "")
    return (f"{where}{what} [{lo}, {hi}) races in-flight aload "
            f"{who} -> [{w_lo}, {w_hi}); await it first")


@dataclass
class Request:
    rid: int
    kind: int                 # LOAD | STORE
    spm_addr: int
    mem_addr: int
    size: int
    issue_time: float
    done_time: float = 0.0
    data: Optional[bytes] = None  # astore payload captured at issue
    status: int = 0               # AMART status (§3.2): farmem.STATUS_*


class SpmOverflow(ValueError):
    pass


class AsyncEngineBase:
    """Shared SPM/config plumbing for the scalar and batched engines."""

    #: True when the engine accepts epoch staging (stage_epoch/flush_epoch/
    #: getfin_epoch); the EpochScheduler probes this and falls back to the
    #: per-command batched protocol when it's absent.
    supports_epoch = False

    def __init__(self, config: EngineConfig,
                 far_memory: Optional[FarMemoryModel] = None,
                 backing: Optional[np.ndarray] = None,
                 record_trace: bool = False, label: str = ""):
        self.config = config
        # diagnostic tag ("core3" in a rack) prefixing invariant failures,
        # so a multi-engine run names the stack that leaked an ID
        self.label = label
        self.far = far_memory or InstantMemory()
        # far-memory backing store (uint8); tests pass real arrays here
        self.mem = backing if backing is not None else np.zeros(1 << 20, np.uint8)
        meta_bytes = config.queue_length * AMART_ENTRY_BYTES
        if meta_bytes >= config.spm_bytes:
            raise SpmOverflow(
                f"queue_length={config.queue_length} needs {meta_bytes}B of "
                f"metadata but SPM is {config.spm_bytes}B")
        # data area = SPM minus the AMART/queue metadata area (queue_base..)
        self.spm_data_bytes = config.spm_bytes - meta_bytes
        self.spm = np.zeros(self.spm_data_bytes, np.uint8)
        self.now = 0.0
        # differential-test hook: ("issue", kind, rid, spm, mem, size, done)
        # and ("fin", rid) tuples, in call order
        self.trace: Optional[list] = [] if record_trace else None
        self.stats = {"aload": 0, "astore": 0, "getfin": 0, "getfin_empty": 0,
                      "alloc_fail": 0, "free_refills": 0, "fin_refills": 0}
        # host-side observability (NOT architectural state): Python-level
        # crossings of the AMI surface and the rows they carried. One scalar
        # aload = 1 entry / 1 row; one flush_epoch = 1 entry / n rows.
        self.host_entries = 0
        self.host_rows = 0
        # fault mode: statuses ride the AMART out-of-band with the done
        # times; after getfin() `fin_status` holds the retired request's
        # status, after getfin_all()/getfin_epoch() `fin_statuses` aligns
        # with the returned rids. Only maintained when the far model
        # injects faults — zero-fault runs never touch these.
        self.fault_enabled = bool(getattr(self.far, "fault_enabled", False))
        self.fin_status = 0
        self.fin_statuses = None
        # AmuConfig(sanitize=True) shadow-state checker (see
        # repro_torch.analysis.sanitizer); None = every hook below is skipped.
        # `port_name` is a pure diagnostic tag (sessions stamp the running
        # port's name) used only in race/leak messages.
        self.sanitizer = None
        self.port_name = ""

    # ----------------------------------------------------------------- AMI
    def aload(self, spm_addr: int, mem_addr: int, size: Optional[int] = None) -> int:
        """Far memory -> SPM. Returns request ID, 0 if ID allocation failed."""
        self.host_entries += 1
        self.host_rows += 1
        return self._issue(LOAD, spm_addr, mem_addr, size)

    def astore(self, spm_addr: int, mem_addr: int, size: Optional[int] = None) -> int:
        """SPM -> far memory. Returns request ID, 0 if ID allocation failed."""
        self.host_entries += 1
        self.host_rows += 1
        return self._issue(STORE, spm_addr, mem_addr, size)

    def getfin_all(self) -> List[int]:
        """Drain every currently-completed ID (in finished-list order)."""
        out: List[int] = []
        if self.fault_enabled:
            sts: List[int] = []
            while True:
                rid = self.getfin()
                if rid == 0:
                    self.fin_statuses = sts
                    return out
                out.append(rid)
                sts.append(self.fin_status)
        while True:
            rid = self.getfin()
            if rid == 0:
                return out
            out.append(rid)

    # Batch AMI entry points. The base implementations loop the scalar issue
    # path, so vector commands (AloadVec/AstoreVec) run against any engine;
    # BatchedAsyncMemoryEngine overrides them with true vector paths.
    def aload_batch(self, spm_addrs, mem_addrs, sizes=None) -> np.ndarray:
        """Vectorized aload: returns rids (0 where ID allocation failed)."""
        self.host_entries += 1
        self.host_rows += int(np.size(spm_addrs))
        return self._issue_seq(LOAD, spm_addrs, mem_addrs, sizes)

    def astore_batch(self, spm_addrs, mem_addrs, sizes=None) -> np.ndarray:
        """Vectorized astore: returns rids (0 where ID allocation failed)."""
        self.host_entries += 1
        self.host_rows += int(np.size(spm_addrs))
        return self._issue_seq(STORE, spm_addrs, mem_addrs, sizes)

    def _issue_seq(self, kind: int, spm_addrs, mem_addrs,
                   sizes=None) -> np.ndarray:
        spm_addrs = np.asarray(spm_addrs, np.int64)
        mem_addrs = np.asarray(mem_addrs, np.int64)
        n = spm_addrs.size
        if sizes is None:
            szs = [None] * n
        elif np.ndim(sizes) == 0:              # shared granularity
            szs = [int(sizes)] * n
        else:
            szs = [int(s) for s in np.asarray(sizes, np.int64).ravel()]
        rids = np.zeros(n, np.int64)
        for i in range(n):
            rids[i] = self._issue(kind, int(spm_addrs[i]), int(mem_addrs[i]),
                                  szs[i])
        return rids

    # -------------------------------------------- config registers (Table 1)
    CFG_REGISTERS = ("granularity", "queue_base", "queue_length")

    def cfgrr(self, reg: str) -> int:
        """Read a configuration register into a 'GPR' (Table 1)."""
        if reg == "granularity":
            return self.config.granularity
        if reg == "queue_base":
            return self.spm_data_bytes        # metadata area starts past data
        if reg == "queue_length":
            return self.config.queue_length
        raise KeyError(reg)

    def cfgrw(self, reg: str, value: int) -> None:
        """Write a configuration register. `queue_length` re-initializes the
        metadata area (only legal with no requests outstanding — the paper's
        software contract for reconfiguration)."""
        if reg == "granularity":
            self.config = dataclasses.replace(self.config, granularity=value)
            return
        if reg == "queue_length":
            if self.outstanding or self.finished_pending or self.active_requests:
                raise RuntimeError("cannot resize queue with requests in flight")
            meta = value * AMART_ENTRY_BYTES
            if meta >= self.config.spm_bytes:
                raise SpmOverflow("queue_length metadata exceeds SPM")
            self.config = dataclasses.replace(self.config, queue_length=value)
            self.spm_data_bytes = self.config.spm_bytes - meta
            self.spm = self.spm[:self.spm_data_bytes].copy() if \
                self.spm.size > self.spm_data_bytes else np.concatenate(
                    [self.spm, np.zeros(self.spm_data_bytes - self.spm.size,
                                        np.uint8)])
            self._reset_id_pool(value)
            return
        raise KeyError(reg)

    # ------------------------------------------------- synchronous SPM access
    #
    # Zero-copy contract: `spm_read` returns a READ-ONLY numpy view aliasing
    # the live SPM byte array — NOT a snapshot. The view observes every later
    # `spm_write` and every DMA retirement that lands in its range; a port
    # that needs the bytes to survive such an overwrite must `.copy()` (or
    # double-buffer its SPM slots). Views are never writable: all mutation
    # goes through `spm_write`, which accepts bytes or any C-contiguous
    # ndarray (so ports can hand back computed arrays without `.tobytes()`).
    def spm_write(self, spm_addr: int, data) -> None:
        if isinstance(data, np.ndarray):
            arr = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        else:
            arr = np.frombuffer(data, np.uint8)
        self._check_bounds(spm_addr, arr.size, "spm_write")
        if self.sanitizer is not None:
            self.sanitizer.on_spm_access(spm_addr, arr.size, "spm_write")
        self.spm[spm_addr:spm_addr + arr.size] = arr

    def spm_read(self, spm_addr: int, size: int) -> np.ndarray:
        self._check_bounds(spm_addr, size, "spm_read")
        if self.sanitizer is not None:
            self.sanitizer.on_spm_access(spm_addr, size, "spm_read")
        view = self.spm[spm_addr:spm_addr + size]
        view.flags.writeable = False
        return view

    def _check_bounds(self, spm_addr: int, size: int,
                      what: str = "SPM access") -> None:
        if spm_addr < 0 or size < 0 or spm_addr + size > self.spm_data_bytes:
            raise SpmOverflow(f"{what} [{spm_addr}, {spm_addr+size}) "
                              f"outside data area of {self.spm_data_bytes}B")

    def drain(self) -> None:
        """Advance past every outstanding completion (functional mode helper)."""
        while self.outstanding:
            self.advance(self.next_completion_time)

    @property
    def free_ids(self) -> int:
        """IDs currently allocatable (ASMC free list + ALSU cache)."""
        return len(self._free) + len(self._free_cache)

    @property
    def _where(self) -> str:
        return f"{self.label}: " if self.label else ""

    # subclass responsibilities --------------------------------------------
    def advance(self, now: float) -> None:
        raise NotImplementedError

    def getfin(self) -> int:
        raise NotImplementedError

    def _issue(self, kind: int, spm_addr: int, mem_addr: int,
               size: Optional[int]) -> int:
        raise NotImplementedError

    def _reset_id_pool(self, queue_length: int) -> None:
        raise NotImplementedError

    def done_time(self, rid: int) -> float:
        raise NotImplementedError

    def done_times(self, rids) -> np.ndarray:
        """Vector :meth:`done_time` (schedulers use it for wake planning)."""
        return np.array([self.done_time(int(r)) for r in np.ravel(rids)])

    @property
    def active_requests(self) -> int:
        """Number of allocated IDs (AMART entries in use)."""
        raise NotImplementedError


class AsyncMemoryEngine(AsyncEngineBase):
    """Scalar reference engine — the differential-testing oracle.

    As the oracle it also polices the zero-copy contract: a synchronous SPM
    access that overlaps the destination of an in-flight LOAD is a data race
    (the DMA will clobber, or race with, the access) and raises immediately
    here, so view-aliasing bugs fail loudly in differential tests instead of
    silently corrupting the batched path. In-flight STOREs don't conflict:
    their payload was captured at issue.
    """

    def __init__(self, config: EngineConfig,
                 far_memory: Optional[FarMemoryModel] = None,
                 backing: Optional[np.ndarray] = None,
                 record_trace: bool = False, label: str = ""):
        super().__init__(config, far_memory, backing, record_trace, label)
        # ASMC-side lists (IDs are 1-based; 0 is the failure code)
        self._free: Deque[int] = deque(range(1, config.queue_length + 1))
        self._finished: Deque[int] = deque()
        self.amart: Dict[int, Request] = {}
        self._pending: List[Tuple[float, int]] = []  # (done_time, rid)
        # ALSU list-vector registers (metadata batching caches)
        self._free_cache: Deque[int] = deque()
        self._fin_cache: Deque[int] = deque()

    # ------------------------------------------------------------------ time
    def advance(self, now: float) -> None:
        """Move the clock; retire far-memory completions into the finished list."""
        self.now = max(self.now, now)
        while self._pending and self._pending[0][0] <= self.now:
            _, rid = heapq.heappop(self._pending)
            if self.sanitizer is not None:
                self.sanitizer.on_retire((rid,))
            req = self.amart[rid]
            if req.status != 0:
                # failed request: no data moved (a LOAD leaves the SPM slot
                # stale, a STORE leaves far memory unwritten) — recovery is
                # the scheduler's RetryPolicy, not silent completion
                self._finished.append(rid)
                continue
            if req.kind == LOAD:
                src = self.mem[req.mem_addr:req.mem_addr + req.size]
                self.spm[req.spm_addr:req.spm_addr + req.size] = src
            else:
                self.mem[req.mem_addr:req.mem_addr + req.size] = np.frombuffer(
                    req.data, np.uint8)
            self._finished.append(rid)

    @property
    def outstanding(self) -> int:
        return len(self._pending)

    @property
    def next_completion_time(self) -> Optional[float]:
        return self._pending[0][0] if self._pending else None

    # ------------------------------------------- zero-copy race detection
    def _assert_no_inflight_load_overlap(self, spm_addr: int, size: int,
                                         what: str) -> None:
        end = spm_addr + size
        for _, rid in self._pending:
            req = self.amart[rid]
            if (req.kind == LOAD and spm_addr < req.spm_addr + req.size
                    and req.spm_addr < end):
                raise AssertionError(format_race(
                    self._where, what, spm_addr, end, rid,
                    req.spm_addr, req.spm_addr + req.size, self.port_name))

    def spm_write(self, spm_addr: int, data) -> None:
        size = data.nbytes if isinstance(data, np.ndarray) else len(data)
        self._assert_no_inflight_load_overlap(spm_addr, size, "spm_write")
        super().spm_write(spm_addr, data)

    def spm_read(self, spm_addr: int, size: int) -> np.ndarray:
        self._assert_no_inflight_load_overlap(spm_addr, size, "spm_read")
        return super().spm_read(spm_addr, size)

    @property
    def finished_pending(self) -> int:
        return len(self._finished) + len(self._fin_cache)

    @property
    def active_requests(self) -> int:
        return len(self.amart)

    def done_time(self, rid: int) -> float:
        return self.amart[rid].done_time

    # ----------------------------------------------------------------- AMI
    def _alloc_id(self) -> int:
        if not self._free_cache:
            if not self._free:
                self.stats["alloc_fail"] += 1
                return 0
            # batch refill from the ASMC free list (one L2-latency round trip)
            n = min(self.config.batch_ids, len(self._free))
            self._free_cache.extend(self._free.popleft() for _ in range(n))
            self.stats["free_refills"] += 1
        return self._free_cache.popleft()

    def _issue(self, kind: int, spm_addr: int, mem_addr: int,
               size: Optional[int]) -> int:
        size = size or self.config.granularity
        self._check_bounds(spm_addr, size)
        rid = self._alloc_id()
        if rid == 0:
            return 0
        req = Request(rid, kind, spm_addr, mem_addr, size, self.now)
        if kind == STORE:
            req.data = self.spm[spm_addr:spm_addr + size].tobytes()
        req.done_time = self.far.issue(self.now, size, mem_addr)
        if self.fault_enabled:
            req.status = self.far.last_status
        self.amart[rid] = req
        heapq.heappush(self._pending, (req.done_time, rid))
        if self.sanitizer is not None:
            self.sanitizer.on_issue(kind, rid, spm_addr, size)
        self.stats["aload" if kind == LOAD else "astore"] += 1
        if self.trace is not None:
            self.trace.append(("issue", kind, rid, spm_addr, mem_addr, size,
                               req.done_time))
        return rid

    def getfin(self) -> int:
        """Return a completed request ID (0 if none). Frees the ID."""
        self.advance(self.now)
        self.host_entries += 1
        self.host_rows += 1
        self.stats["getfin"] += 1
        if not self._fin_cache:
            if not self._finished:
                self.stats["getfin_empty"] += 1
                if self.trace is not None:
                    self.trace.append(("fin", 0))
                return 0
            n = min(self.config.batch_ids, len(self._finished))
            self._fin_cache.extend(self._finished.popleft() for _ in range(n))
            self.stats["fin_refills"] += 1
        rid = self._fin_cache.popleft()
        if self.fault_enabled:
            self.fin_status = self.amart[rid].status
        del self.amart[rid]
        self._free.append(rid)  # ID returns to the ASMC free list
        if self.trace is not None:
            self.trace.append(("fin", rid))
        return rid

    def _reset_id_pool(self, queue_length: int) -> None:
        self._free = deque(range(1, queue_length + 1))
        self._free_cache.clear()
        self._fin_cache.clear()
        self._finished.clear()

    # ----------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        """ID conservation: every ID is in exactly one place."""
        ids = (list(self._free) + list(self._free_cache) + list(self._fin_cache)
               + list(self._finished) + [r for _, r in self._pending])
        in_flight_fin = set(self._finished) | set(self._fin_cache)
        pend = {r for _, r in self._pending}
        assert len(ids) == self.config.queue_length, (
            f"{self._where}ID leak: {len(ids)} != {self.config.queue_length}")
        assert len(set(ids)) == len(ids), f"{self._where}duplicate ID"
        assert set(self.amart) == (pend | in_flight_fin), \
            f"{self._where}AMART out of sync"


class _IdRing:
    """Fixed-capacity int64 FIFO ring buffer (the ASMC's SPM-resident lists)."""

    __slots__ = ("buf", "cap", "head", "n")

    def __init__(self, cap: int, fill: Optional[np.ndarray] = None):
        self.cap = cap
        self.buf = np.zeros(cap, np.int64)
        self.head = 0
        self.n = 0
        if fill is not None:
            self.buf[:fill.size] = fill
            self.n = int(fill.size)

    def __len__(self) -> int:
        return self.n

    def pop(self) -> int:
        rid = int(self.buf[self.head])
        self.head = (self.head + 1) % self.cap
        self.n -= 1
        return rid

    def pop_many(self, k: int) -> np.ndarray:
        if self.head + k <= self.cap:                 # contiguous fast path
            out = self.buf[self.head:self.head + k].copy()
        else:
            out = self.buf[(self.head + np.arange(k)) % self.cap].copy()
        self.head = (self.head + k) % self.cap
        self.n -= k
        return out

    def push(self, rid: int) -> None:
        self.buf[(self.head + self.n) % self.cap] = rid
        self.n += 1

    def push_many(self, rids: np.ndarray) -> None:
        k = len(rids)
        p = (self.head + self.n) % self.cap
        if p + k <= self.cap:                          # contiguous fast path
            self.buf[p:p + k] = rids
        else:
            self.buf[(p + np.arange(k)) % self.cap] = rids
        self.n += k

    def tolist(self) -> List[int]:
        return self.buf[(self.head + np.arange(self.n)) % self.cap].tolist()


class BatchedAsyncMemoryEngine(AsyncEngineBase):
    """Structure-of-arrays engine with vectorized completion retirement.

    Scalar AMI calls (`aload`/`astore`/`getfin`) are call-for-call
    trace-identical to :class:`AsyncMemoryEngine`; the batch entry points
    (`aload_batch`/`astore_batch`/`getfin_all`) retire whole vectors per
    Python call, which is what makes latency x queue-depth sweeps tractable.

    On top of those sits the **epoch surface** (`stage_epoch` /
    `flush_epoch` / `getfin_epoch`): the EpochScheduler stages every port's
    issue batch for a whole scheduler epoch and the engine enters the far
    model ONCE with the concatenated SoA mega-batch
    (:meth:`FarMemoryModel.issue_epoch`). Allocation, bounds checks and
    store-payload capture stay at staging time (they observe live SPM/ID
    state); far-model math, AMART scatter, trace rows and the clock advance
    are deferred to the flush — bit-identical to issuing each staged batch
    through `aload_batch`/`astore_batch` at its staged `now`.
    """

    supports_epoch = True

    def __init__(self, config: EngineConfig,
                 far_memory: Optional[FarMemoryModel] = None,
                 backing: Optional[np.ndarray] = None,
                 record_trace: bool = False, label: str = ""):
        super().__init__(config, far_memory, backing, record_trace, label)
        cap = config.queue_length
        self._free = _IdRing(cap, fill=np.arange(1, cap + 1))
        self._finished = _IdRing(cap)
        # ALSU free-ID cache as an array + cursor (bulk allocation pops a
        # slice instead of draining a deque element-wise)
        self._fc = np.empty(0, np.int64)
        self._fc_head = 0
        self._fin_cache: Deque[int] = deque()
        # SoA AMART, indexed by rid (slot 0 unused — 0 is the failure code)
        self._kind = np.zeros(cap + 1, np.int8)
        self._spm_a = np.zeros(cap + 1, np.int64)
        self._mem_a = np.zeros(cap + 1, np.int64)
        self._size = np.zeros(cap + 1, np.int64)
        self._issue_t = np.zeros(cap + 1, np.float64)
        self._done_t = np.zeros(cap + 1, np.float64)
        self._active = np.zeros(cap + 1, bool)
        # per-request AMART status (farmem.STATUS_*); stays all-OK and
        # untouched on the zero-fault path
        self._status = np.zeros(cap + 1, np.int8)
        self._store_data: List[Optional[np.ndarray]] = [None] * (cap + 1)
        # unsorted in-flight rid vector (replaces the per-event heapq)
        self._pend = np.zeros(cap, np.int64)
        self._pend_n = 0
        self._pend_min = math.inf
        # epoch staging: (kind, now, rids, spm, mem, sizes) per staged batch
        self._ep_segs: List[tuple] = []
        self._ep_last_now: Optional[float] = None
        # shared-granularity sizes arrays, reused across batch/stage calls
        # (read-only once handed out; every consumer copies or slices)
        self._gran_cache: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------ time
    def advance(self, now: float) -> None:
        """Move the clock; retire ALL due completions in one vectorized step,
        ordered by (done_time, rid) exactly like the scalar heapq."""
        self.now = max(self.now, now)
        if self._pend_n == 0 or self._pend_min > self.now:
            return
        rids = self._pend[:self._pend_n]
        done = self._done_t[rids]
        due = done <= self.now
        fin = rids[due]
        if fin.size > 1:
            fin = fin[np.lexsort((fin, done[due]))]
        if self.fault_enabled and fin.size:
            # failed requests retire without moving data (the scheduler's
            # RetryPolicy owns recovery); retirement order is unchanged
            self._move_data(fin[self._status[fin] == 0])
        else:
            self._move_data(fin)
        if self.sanitizer is not None:
            self.sanitizer.on_retire(fin)
        self._finished.push_many(fin)
        keep = rids[~due]
        self._pend[:keep.size] = keep
        self._pend_n = keep.size
        self._pend_min = float(self._done_t[keep].min()) if keep.size \
            else math.inf

    def _move_data(self, fin: np.ndarray) -> None:
        """Perform the DMA for retired requests, preserving retirement order.

        Consecutive same-kind runs are vectorized; run boundaries keep
        load-after-store ordering on overlapping far-memory regions, and
        in-order fancy assignment keeps last-writer-wins within a run.
        """
        if fin.size == 0:
            return
        kinds = self._kind[fin]
        bounds = [0, *(np.flatnonzero(kinds[1:] != kinds[:-1]) + 1).tolist(),
                  fin.size]
        for b in range(len(bounds) - 1):
            i, j = bounds[b], bounds[b + 1]
            run = fin[i:j]
            if j - i <= 4:                  # few rows: in-order scalar copies
                if kinds[i] == LOAD:        # (the reference semantics) beat
                    for rid in run.tolist():     # the pattern analysis
                        a, m, s = (int(self._spm_a[rid]),
                                   int(self._mem_a[rid]), int(self._size[rid]))
                        self.spm[a:a + s] = self.mem[m:m + s]
                else:
                    for rid in run.tolist():
                        m, s = int(self._mem_a[rid]), int(self._size[rid])
                        self.mem[m:m + s] = self._store_data[rid]
                continue
            sizes = self._size[run]
            same_gran = sizes.size > 1 and bool((sizes == sizes[0]).all())
            if kinds[i] == LOAD:
                if same_gran:
                    self._move_loads_same_gran(run, int(sizes[0]))
                else:
                    # mixed granularities (or a single request): scalar copies
                    for rid in run:
                        a, m, s = (int(self._spm_a[rid]),
                                   int(self._mem_a[rid]), int(self._size[rid]))
                        self.spm[a:a + s] = self.mem[m:m + s]
            else:
                if same_gran:
                    self._move_stores_same_gran(run, int(sizes[0]))
                else:
                    for rid in run:
                        m, s = int(self._mem_a[rid]), int(self._size[rid])
                        self.mem[m:m + s] = self._store_data[rid]

    def _move_loads_same_gran(self, run: np.ndarray, g: int) -> None:
        """Same-granularity load retirement: one copy per run instead of
        O(n*g) fancy-index arithmetic where the access pattern allows.

        Tiers: (1) both sides form one ascending contiguous block -> a single
        reshaped slice copy (sequential workloads: STREAM/IS blocks); (2) g
        is a machine word and everything is g-aligned -> one dtype-view
        gather/scatter of n elements (GUPS-style random words); (3) both
        sides decompose into a FEW piecewise-contiguous segments -> one
        slice copy per segment (vector ports that concatenate several
        sequential slot windows into one AloadVec, e.g. STREAM's b|c
        halves); (4) general same-size 2D fancy gather. In-order
        segment/fancy assignment keeps last-writer-wins for duplicate
        destinations within a run.
        """
        assert g > 0 and (self._size[run] == g).all(), \
            "same-granularity fast path fed mixed sizes"
        spm_a = self._spm_a[run]
        mem_a = self._mem_a[run]
        n = run.size
        d_spm = spm_a[1:] - spm_a[:-1]
        d_mem = mem_a[1:] - mem_a[:-1]
        if (d_spm == g).all() and (d_mem == g).all():
            s0, m0 = int(spm_a[0]), int(mem_a[0])
            self.spm[s0:s0 + n * g] = self.mem[m0:m0 + n * g]
            return
        if g in (1, 2, 4, 8) and not ((spm_a % g).any() or (mem_a % g).any()):
            dt = np.dtype(f"u{g}")
            sv = self.spm[:(self.spm.size // g) * g].view(dt)
            mv = self.mem[:(self.mem.size // g) * g].view(dt)
            sv[spm_a // g] = mv[mem_a // g]
            return
        if g >= 256:          # big blocks: piecewise-contiguous segments
            starts = np.flatnonzero((d_spm != g) | (d_mem != g)) + 1
            if starts.size + 1 <= max(1, n // 4):
                bounds = [0, *starts.tolist(), n]
                for i in range(len(bounds) - 1):
                    lo, hi = bounds[i], bounds[i + 1]
                    s0, m0 = int(spm_a[lo]), int(mem_a[lo])
                    ln = (hi - lo) * g
                    self.spm[s0:s0 + ln] = self.mem[m0:m0 + ln]
                return
        if g % 8 == 0 and not ((spm_a % 8).any() or (mem_a % 8).any()):
            # word-aligned scatter (chase nodes): 8x fewer gathered elements
            w = g // 8
            sv = self.spm[:(self.spm.size // 8) * 8].view(np.uint64)
            mv = self.mem[:(self.mem.size // 8) * 8].view(np.uint64)
            cols = np.arange(w)
            sv[(spm_a // 8)[:, None] + cols] = mv[(mem_a // 8)[:, None] + cols]
            return
        cols = np.arange(g)
        self.spm[spm_a[:, None] + cols] = self.mem[mem_a[:, None] + cols]

    def _move_stores_same_gran(self, run: np.ndarray, g: int) -> None:
        """Same-granularity store retirement (payloads captured at issue)."""
        assert g > 0 and (self._size[run] == g).all(), \
            "same-granularity fast path fed mixed sizes"
        mem_a = self._mem_a[run]
        n = run.size
        # one concatenate over the captured row views — no per-rid fill loop
        store = self._store_data
        data = np.concatenate([store[rid] for rid in run.tolist()]) \
            if n > 1 else store[int(run[0])]
        if (mem_a[1:] - mem_a[:-1] == g).all():
            m0 = int(mem_a[0])
            self.mem[m0:m0 + n * g] = data
            return
        if g in (1, 2, 4, 8) and not (mem_a % g).any():
            dt = np.dtype(f"u{g}")
            mv = self.mem[:(self.mem.size // g) * g].view(dt)
            mv[mem_a // g] = data.view(dt)
            return
        if g % 8 == 0 and not (mem_a % 8).any():
            w = g // 8
            mv = self.mem[:(self.mem.size // 8) * 8].view(np.uint64)
            mv[(mem_a // 8)[:, None] + np.arange(w)] = \
                np.ascontiguousarray(data).view(np.uint64).reshape(n, w)
            return
        self.mem[mem_a[:, None] + np.arange(g)] = data.reshape(n, g)

    @property
    def outstanding(self) -> int:
        return int(self._pend_n)

    @property
    def next_completion_time(self) -> Optional[float]:
        return self._pend_min if self._pend_n else None

    @property
    def finished_pending(self) -> int:
        return len(self._finished) + len(self._fin_cache)

    @property
    def active_requests(self) -> int:
        return int(self._active.sum())

    def done_time(self, rid: int) -> float:
        return float(self._done_t[rid])

    def done_times(self, rids) -> np.ndarray:
        return self._done_t[np.asarray(rids, np.int64)]

    # ----------------------------------------------------------------- AMI
    @property
    def free_ids(self) -> int:
        return len(self._free) + (self._fc.size - self._fc_head)

    def _alloc_id(self) -> int:
        if self._fc_head >= self._fc.size:
            if len(self._free) == 0:
                self.stats["alloc_fail"] += 1
                return 0
            n = min(self.config.batch_ids, len(self._free))
            self._fc = self._free.pop_many(n)
            self._fc_head = 0
            self.stats["free_refills"] += 1
        rid = int(self._fc[self._fc_head])
        self._fc_head += 1
        return rid

    def _alloc_ids(self, n: int) -> np.ndarray:
        """Allocate up to n IDs — state/stat-equivalent to n scalar allocs."""
        head = self._fc_head
        avail = self._fc.size - head
        if n <= avail:                      # cache covers the whole batch
            self._fc_head = head + n
            return self._fc[head:head + n]
        parts = [self._fc[head:]] if avail else []
        self._fc_head = self._fc.size
        need = n - avail
        if need > 0 and len(self._free):
            # replicate the batch_ids-chunked refill accounting (same
            # free_refills count, same leftover cache) with ONE ring pop
            bsz = self.config.batch_ids
            fn = len(self._free)
            refills = total = last = 0
            rem = need
            while rem > 0 and fn:
                last = min(bsz, fn)
                fn -= last
                total += last
                refills += 1
                rem -= min(rem, last)
            got = self._free.pop_many(total)
            self.stats["free_refills"] += refills
            use = min(need, total)
            parts.append(got[:use])
            if use < total:              # leftover becomes the new cache
                self._fc = got[total - last:]
                self._fc_head = use - (total - last)
            need -= use
        if need:
            self.stats["alloc_fail"] += need
        if len(parts) == 1:
            return parts[0]
        return np.concatenate(parts) if parts else self._fc[:0]

    def _set_request(self, rid: int, kind: int, spm_addr: int, mem_addr: int,
                     size: int, done: float) -> None:
        self._kind[rid] = kind
        self._spm_a[rid] = spm_addr
        self._mem_a[rid] = mem_addr
        self._size[rid] = size
        self._issue_t[rid] = self.now
        self._done_t[rid] = done
        self._active[rid] = True
        self._pend[self._pend_n] = rid
        self._pend_n += 1
        if done < self._pend_min:
            self._pend_min = float(done)

    def _issue(self, kind: int, spm_addr: int, mem_addr: int,
               size: Optional[int]) -> int:
        size = size or self.config.granularity
        self._check_bounds(spm_addr, size)
        rid = self._alloc_id()
        if rid == 0:
            return 0
        if kind == STORE:
            self._store_data[rid] = self.spm[spm_addr:spm_addr + size].copy()
        done = self.far.issue(self.now, size, mem_addr)
        if self.fault_enabled:
            self._status[rid] = self.far.last_status
        self._set_request(rid, kind, spm_addr, mem_addr, size, done)
        if self.sanitizer is not None:
            self.sanitizer.on_issue(kind, rid, spm_addr, size)
        self.stats["aload" if kind == LOAD else "astore"] += 1
        if self.trace is not None:
            self.trace.append(("issue", kind, rid, spm_addr, mem_addr, size,
                               done))
        return rid

    def getfin(self) -> int:
        """Return a completed request ID (0 if none). Frees the ID."""
        self.advance(self.now)
        self.host_entries += 1
        self.host_rows += 1
        self.stats["getfin"] += 1
        if not self._fin_cache:
            if len(self._finished) == 0:
                self.stats["getfin_empty"] += 1
                if self.trace is not None:
                    self.trace.append(("fin", 0))
                return 0
            n = min(self.config.batch_ids, len(self._finished))
            self._fin_cache.extend(self._finished.pop_many(n).tolist())
            self.stats["fin_refills"] += 1
        rid = self._fin_cache.popleft()
        if self.fault_enabled:
            self.fin_status = int(self._status[rid])
        self._active[rid] = False
        self._store_data[rid] = None
        self._free.push(rid)
        if self.trace is not None:
            self.trace.append(("fin", rid))
        return rid

    # ------------------------------------------------------- batch AMI path
    def _coerce_batch(self, spm_addrs, mem_addrs, sizes):
        """Shared front half of the batch/epoch issue paths: int64 coercion,
        `size or granularity`, and the vectorized SPM bounds check.
        Returns the shared granularity `g0` too (0 for per-row sizes)."""
        spm_addrs = np.asarray(spm_addrs, np.int64)
        mem_addrs = np.asarray(mem_addrs, np.int64)
        n = spm_addrs.size
        if sizes is None or sizes.__class__ is int or np.ndim(sizes) == 0:
            # shared granularity (`size or granularity`, like the scalar
            # path); the filled array is cached and handed out read-only
            g0 = int(sizes or 0) or self.config.granularity
            sz = self._gran_cache.get(g0)
            if sz is None or sz.size < n:
                sz = np.full(max(n, 1024), g0, np.int64)
                self._gran_cache[g0] = sz
            sizes = sz[:n]
        else:
            # match the scalar path's `size or granularity` coercion
            g0 = 0
            sizes = np.asarray(sizes, np.int64)
            sizes = np.where(sizes == 0, self.config.granularity, sizes)
        if n:
            if g0:
                # shared granularity: two reductions replace the row masks
                ok = (g0 > 0 and int(spm_addrs.min()) >= 0
                      and int(spm_addrs.max()) + g0 <= self.spm_data_bytes)
            else:
                ok = not bool(((spm_addrs < 0) | (sizes < 0)
                               | (spm_addrs + sizes
                                  > self.spm_data_bytes)).any())
            if not ok:
                bad_mask = ((spm_addrs < 0) | (sizes < 0)
                            | (spm_addrs + sizes > self.spm_data_bytes))
                bad = int(np.argmax(bad_mask))
                raise SpmOverflow(
                    f"SPM access [{spm_addrs[bad]}, "
                    f"{spm_addrs[bad] + sizes[bad]}) "
                    f"outside data area of {self.spm_data_bytes}B")
        return spm_addrs, mem_addrs, sizes, n, g0

    def _capture_stores(self, ok: np.ndarray, k: int, spm_addrs: np.ndarray,
                        sizes: np.ndarray, g0: int = 0) -> None:
        """Capture astore payloads from live SPM at issue/staging time.
        `g0` (when nonzero) promises every row shares that granularity."""
        if g0 or (sizes[:k] == sizes[0]).all():
            # same-granularity capture: one copy, row views out — a
            # single reshaped slice when the source slots are contiguous
            # (vector ports), else one fancy gather
            g = g0 or int(sizes[0])
            if k > 1 and (spm_addrs[1:k] - spm_addrs[:k - 1] == g).all():
                a0 = int(spm_addrs[0])
                rows = self.spm[a0:a0 + k * g].copy().reshape(k, g)
            else:
                rows = self.spm[spm_addrs[:k, None] + np.arange(g)]
            store = self._store_data
            for rid, row in zip(ok.tolist(), rows):
                store[rid] = row
        else:
            spm, store = self.spm, self._store_data
            for rid, a, s in zip(ok.tolist(), spm_addrs.tolist(),
                                 sizes.tolist()):
                store[rid] = spm[a:a + s].copy()

    def _issue_batch(self, kind: int, spm_addrs, mem_addrs,
                     sizes=None) -> np.ndarray:
        spm_addrs, mem_addrs, sizes, n, g0 = self._coerce_batch(
            spm_addrs, mem_addrs, sizes)
        self.host_entries += 1
        self.host_rows += n
        got = self._alloc_ids(n)
        k = len(got)
        rids = np.zeros(n, np.int64)
        if k == 0:
            return rids
        ok = np.asarray(got, np.int64)
        rids[:k] = ok
        if kind == STORE:
            self._capture_stores(ok, k, spm_addrs, sizes, g0)
        done = self.far.issue_batch(self.now, sizes[:k], mem_addrs[:k])
        if self.fault_enabled:
            self._status[ok] = self.far.last_statuses
        self._kind[ok] = kind
        self._spm_a[ok] = spm_addrs[:k]
        self._mem_a[ok] = mem_addrs[:k]
        self._size[ok] = sizes[:k]
        self._issue_t[ok] = self.now
        self._done_t[ok] = done
        self._active[ok] = True
        self._pend[self._pend_n:self._pend_n + k] = ok
        self._pend_n += k
        if k:
            self._pend_min = min(self._pend_min, float(done.min()))
        if self.sanitizer is not None:
            self.sanitizer.on_issue_batch(kind, ok, spm_addrs[:k], sizes[:k])
        self.stats["aload" if kind == LOAD else "astore"] += k
        if self.trace is not None:
            for i in range(k):
                self.trace.append(("issue", kind, int(ok[i]),
                                   int(spm_addrs[i]), int(mem_addrs[i]),
                                   int(sizes[i]), float(done[i])))
        return rids

    def aload_batch(self, spm_addrs, mem_addrs, sizes=None) -> np.ndarray:
        """Vectorized aload: returns rids (0 where ID allocation failed)."""
        return self._issue_batch(LOAD, spm_addrs, mem_addrs, sizes)

    def astore_batch(self, spm_addrs, mem_addrs, sizes=None) -> np.ndarray:
        """Vectorized astore: returns rids (0 where ID allocation failed)."""
        return self._issue_batch(STORE, spm_addrs, mem_addrs, sizes)

    def getfin_all(self) -> List[int]:
        """Drain every completed ID in one call — stat/state-equivalent to
        calling ``getfin()`` until it returns 0 (incl. the final empty poll)."""
        self.advance(self.now)
        c, f = len(self._fin_cache), len(self._finished)
        total = c + f
        self.host_entries += 1
        self.host_rows += total
        self.stats["getfin"] += total + 1
        self.stats["getfin_empty"] += 1
        if total == 0:
            if self.fault_enabled:
                self.fin_statuses = []
            if self.trace is not None:
                self.trace.append(("fin", 0))
            return []
        # after the cache drains, the scalar loop refills batch_ids at a time
        self.stats["fin_refills"] += -(-f // self.config.batch_ids) if f else 0
        rids = list(self._fin_cache)
        self._fin_cache.clear()
        if f:
            rids.extend(self._finished.pop_many(f).tolist())
        arr = np.asarray(rids, np.int64)
        if self.fault_enabled:
            self.fin_statuses = self._status[arr].tolist()
        self._active[arr] = False
        for rid in rids:
            self._store_data[rid] = None
        self._free.push_many(arr)
        if self.trace is not None:
            self.trace.extend(("fin", rid) for rid in rids)
            self.trace.append(("fin", 0))
        return rids

    # ------------------------------------------------------ epoch AMI path
    def stage_epoch(self, kind: int, now: float, spm_addrs, mem_addrs,
                    sizes=None) -> np.ndarray:
        """Stage one port's issue batch for the current epoch.

        Everything that observes *live* state happens here, exactly as it
        would on the immediate path: bounds validation, ID allocation from
        the ASMC free list / ALSU cache (the free pool only shrinks between
        the epoch-top drain and the flush, so staged allocs see the same
        pool the per-command path would), astore payload capture from the
        SPM as it is *now*, and the aload/astore stats. The far-model call,
        AMART scatter, trace rows and clock advance are deferred to
        :meth:`flush_epoch`. Returns rids (0 where allocation failed).
        """
        spm_addrs, mem_addrs, sizes, n, g0 = self._coerce_batch(
            spm_addrs, mem_addrs, sizes)
        # remember the epoch's last staged time even if nothing allocates:
        # the flush replays the per-command path's trailing advance()
        self._ep_last_now = float(now)
        got = self._alloc_ids(n)
        k = len(got)
        if k == 0:
            return np.zeros(n, np.int64)
        ok = np.asarray(got, np.int64)
        if k == n:
            rids = ok                       # full allocation: no zero suffix
        else:
            rids = np.zeros(n, np.int64)
            rids[:k] = ok
        if kind == STORE:
            self._capture_stores(ok, k, spm_addrs, sizes, g0)
        if self.sanitizer is not None:
            # staged requests are in flight from staging time: allocation
            # and store capture already happened against live state
            self.sanitizer.on_issue_batch(kind, ok, spm_addrs[:k], sizes[:k])
        self.stats["aload" if kind == LOAD else "astore"] += k
        self._ep_segs.append((kind, float(now), ok, spm_addrs[:k],
                              mem_addrs[:k], sizes[:k]))
        return rids

    @property
    def epoch_staged(self) -> bool:
        """Anything staged (or staged-and-failed) since the last flush —
        when False, ``flush_epoch`` would be a pure no-op."""
        return bool(self._ep_segs) or self._ep_last_now is not None

    def flush_epoch(self) -> np.ndarray:
        """Issue every staged batch with ONE far-model entry.

        Segments keep their staged `now` (``issue_epoch`` replays per-link /
        per-region draw order exactly), the AMART scatter and per-row trace
        run over the concatenated epoch, and the final ``advance`` to the
        last staged time reproduces the cumulative effect of the immediate
        path's per-command advances (retirement batches concatenate to one
        globally (done, rid)-sorted batch because due-sets partition
        monotonically in time). Returns the done-times, epoch row order.
        """
        segs = self._ep_segs
        last = self._ep_last_now
        self._ep_segs = []
        self._ep_last_now = None
        if not segs:
            if last is not None:
                self.advance(last)
            return np.empty(0, np.float64)
        if len(segs) == 1:
            # one staged batch: issue_epoch over a single segment is defined
            # as exactly one issue_batch — take it directly, skipping the
            # concat/repeat machinery
            kind0, now0, ok, spm, mem, sizes = segs[0]
            k = int(ok.size)
            self.host_entries += 1
            self.host_rows += k
            done = self.far.issue_batch(now0, sizes, mem)
            if self.fault_enabled:
                self._status[ok] = self.far.last_statuses
            self._kind[ok] = kind0
            self._spm_a[ok] = spm
            self._mem_a[ok] = mem
            self._size[ok] = sizes
            self._issue_t[ok] = now0
            self._done_t[ok] = done
            self._active[ok] = True
            self._pend[self._pend_n:self._pend_n + k] = ok
            self._pend_n += k
            self._pend_min = min(self._pend_min, float(done.min()))
            if self.trace is not None:
                for i in range(k):
                    self.trace.append(("issue", kind0, int(ok[i]),
                                       int(spm[i]), int(mem[i]),
                                       int(sizes[i]), float(done[i])))
            self.advance(last)
            return done
        ks = np.array([s[2].size for s in segs], np.int64)
        seg_nows = np.array([s[1] for s in segs], np.float64)
        seg_bounds = np.zeros(ks.size + 1, np.int64)
        np.cumsum(ks, out=seg_bounds[1:])
        ok = np.concatenate([s[2] for s in segs])
        spm = np.concatenate([s[3] for s in segs])
        mem = np.concatenate([s[4] for s in segs])
        sizes = np.concatenate([s[5] for s in segs])
        k = int(ok.size)
        self.host_entries += 1
        self.host_rows += k
        done = self.far.issue_epoch(seg_nows, seg_bounds, sizes, mem)
        if self.fault_enabled:
            self._status[ok] = self.far.last_statuses
        kinds = np.repeat(np.array([s[0] for s in segs], np.int8), ks)
        self._kind[ok] = kinds
        self._spm_a[ok] = spm
        self._mem_a[ok] = mem
        self._size[ok] = sizes
        self._issue_t[ok] = np.repeat(seg_nows, ks)
        self._done_t[ok] = done
        self._active[ok] = True
        self._pend[self._pend_n:self._pend_n + k] = ok
        self._pend_n += k
        self._pend_min = min(self._pend_min, float(done.min()))
        if self.trace is not None:
            for i in range(k):
                self.trace.append(("issue", int(kinds[i]), int(ok[i]),
                                   int(spm[i]), int(mem[i]), int(sizes[i]),
                                   float(done[i])))
        self.advance(last)
        return done

    def getfin_epoch(self, now: float) -> Optional[List[int]]:
        """Epoch-top drain: advance to `now`, then ``getfin_all`` iff
        anything finished. Returns None when nothing was pending — the
        same gate the per-command scheduler applies before draining, so the
        trace/stats stay call-for-call identical."""
        self.advance(now)
        if not self.finished_pending:
            return None
        return self.getfin_all()

    def _reset_id_pool(self, queue_length: int) -> None:
        cap = queue_length
        self._free = _IdRing(cap, fill=np.arange(1, cap + 1))
        self._finished = _IdRing(cap)
        self._fc = np.empty(0, np.int64)
        self._fc_head = 0
        self._fin_cache.clear()
        self._kind = np.zeros(cap + 1, np.int8)
        self._spm_a = np.zeros(cap + 1, np.int64)
        self._mem_a = np.zeros(cap + 1, np.int64)
        self._size = np.zeros(cap + 1, np.int64)
        self._issue_t = np.zeros(cap + 1, np.float64)
        self._done_t = np.zeros(cap + 1, np.float64)
        self._active = np.zeros(cap + 1, bool)
        self._status = np.zeros(cap + 1, np.int8)
        self._store_data = [None] * (cap + 1)
        self._pend = np.zeros(cap, np.int64)
        self._pend_n = 0
        self._pend_min = math.inf

    # ----------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        """ID conservation: every ID is in exactly one place."""
        pend = self._pend[:self._pend_n].tolist()
        ids = (self._free.tolist() + self._fc[self._fc_head:].tolist()
               + list(self._fin_cache) + self._finished.tolist() + pend)
        assert len(ids) == self.config.queue_length, (
            f"{self._where}ID leak: {len(ids)} != {self.config.queue_length}")
        assert len(set(ids)) == len(ids), f"{self._where}duplicate ID"
        in_flight = (set(pend) | set(self._finished.tolist())
                     | set(self._fin_cache))
        assert set(np.nonzero(self._active)[0].tolist()) == in_flight, \
            f"{self._where}AMART out of sync"


ENGINE_KINDS = {"scalar": AsyncMemoryEngine, "batched": BatchedAsyncMemoryEngine}


def make_engine(kind: str, config: EngineConfig,
                far_memory: Optional[FarMemoryModel] = None,
                backing: Optional[np.ndarray] = None,
                record_trace: bool = False, label: str = "") -> AsyncEngineBase:
    """Factory for the `engine=` knob: "scalar" (oracle) or "batched"."""
    try:
        cls = ENGINE_KINDS[kind]
    except KeyError:
        raise KeyError(f"unknown engine kind {kind!r}; "
                       f"known: {sorted(ENGINE_KINDS)}") from None
    return cls(config, far_memory, backing, record_trace=record_trace,
               label=label)
