"""Far-memory device model: latency + bandwidth + queueing, heterogeneous.

Models the paper's Figure 1/7 memory path: requests leave the core through a
link with finite bandwidth and a base latency that ranges from 0.1 µs (fast
CXL) to 5 µs (cross-switch disaggregated memory). Completion time for a
request issued at `t` is::

    t_done = max(t, link_free) + base_latency * mult + size / bandwidth

where `link_free` enforces serialization of request injection on the link
(packets inject back-to-back at `size / bandwidth` spacing), giving Little's
law behaviour: sustained MLP on the device cannot exceed
`bandwidth * latency / granularity`; `mult` is a per-request draw from the
configured :class:`LatencyDistribution` (1.0 when none — the paper's point
that far latencies are "longer *and more variable* than local DRAM").

MLP accounting is closed-form rather than event-driven: since a request is
in flight on [issue, done), the integral of the in-flight count over [0, T]
is exactly ``sum_i(min(done_i, T) - issue_i)``, so the model keeps a flat
ledger of completion times instead of an event heap. A heap exists only in
``max_inflight`` mode, where injection is coupled to completions
(device-side queue backpressure).

**Heterogeneous mode** (``FarMemoryConfig.regions``): the address space
splits into per-range :class:`FarMemoryRegion` tiers — e.g. local-DRAM /
fast-CXL / cross-switch — each with its own latency, bandwidth,
``max_inflight``, latency distribution, and *link*. Requests route by
address in :meth:`issue`/:meth:`issue_batch`; regions naming the same
``link`` contend on one serialization point (shared channel) while keeping
their own closed-form MLP ledgers, request/byte counters, RNG streams and
backpressure queues (:meth:`region_stats`). A single region covering the
whole address space is bit-identical to the flat model.

Determinism contract (pinned by tests/test_batched_engine.py and
tests/test_farmem_regions.py): every latency distribution draws through a
seeded ``np.random.Generator`` whose array fills consume the bitstream
exactly like sequential scalar draws, so ``issue_batch`` is bit-identical
to the equivalent ``issue()`` loop — per region, and across regions via
the **mixed-tier reordering path**: when every region a batch touches is
unlimited (no ``max_inflight`` coupling), the scalar loop's cross-region
interleaving factors exactly into independent per-link injection chains
(rows in original order per link) and per-region latency draws (rows in
original order per RNG stream), so an arbitrarily interleaved batch
vectorizes without replaying run boundaries. Batches touching a
backpressured region keep the consecutive same-region run segmentation
(injection there is coupled to completions through a heap).

:meth:`issue_epoch` extends the same factoring across a whole scheduler
epoch of batches ("segments", each with its own issue time): per-link
chains restart their ``max(now, free)`` only at segment boundaries and
per-region draws concatenate, so one entry reproduces the per-command
call sequence bit-for-bit. The sequential recurrences optionally run as
numba kernels (``host_jit=True`` + numba importable, see
:mod:`repro_torch.core.hostjit`) — bit-identical to the numpy fallback.

The same model backs the functional engine (zero-latency mode), the
cycle-approximate simulator, and the runtime's host-offload tier.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import hostjit

GHZ = 1e9  # cycles are expressed at the simulated core clock (paper: 3 GHz)


# =========================================================================
# Latency distributions
# =========================================================================
class LatencyDistribution:
    """A per-request latency *multiplier* draw (1.0 == the base latency).

    Implementations must be seeded-deterministic AND batch/scalar
    bit-identical: ``draw(rng, n)`` consumes the RNG bitstream exactly like
    ``n`` successive ``draw(rng)`` calls (numpy ``Generator`` array fills
    guarantee this for the primitives used here), so the vectorized
    ``issue_batch`` path reproduces the scalar ``issue()`` loop bit-for-bit.
    """

    kind = "none"

    def draw(self, rng: np.random.Generator, n: Optional[int] = None):
        """One multiplier (``n is None``) or a length-``n`` vector."""
        raise NotImplementedError


@dataclass(frozen=True)
class UniformJitter(LatencyDistribution):
    """Uniform ±``frac`` of the base latency — the typed spelling of the
    legacy ``jitter_frac`` knob (identical draws for the same seed)."""

    frac: float = 0.1
    kind = "uniform"

    def draw(self, rng: np.random.Generator, n: Optional[int] = None):
        if n is None:
            return 1.0 + self.frac * float(rng.uniform(-1.0, 1.0))
        return 1.0 + self.frac * rng.uniform(-1.0, 1.0, size=n)


@dataclass(frozen=True)
class LognormalLatency(LatencyDistribution):
    """Mean-preserving lognormal multiplier (``mu = -sigma^2/2``): the
    heavy-ish right tail of real network/far-memory paths with the mean
    latency pinned to the base, so tail sweeps isolate *variability* from
    operating-point shifts."""

    sigma: float = 0.5
    kind = "lognormal"

    def draw(self, rng: np.random.Generator, n: Optional[int] = None):
        mu = -0.5 * self.sigma * self.sigma
        if n is None:
            return float(rng.lognormal(mu, self.sigma))
        return rng.lognormal(mu, self.sigma, size=n)


@dataclass(frozen=True)
class BimodalTail(LatencyDistribution):
    """Bimodal tail: with probability ``tail_prob`` a request pays
    ``tail_mult``× the base latency (retransmits, switch congestion, remote
    NUMA hops); otherwise exactly the base. p50 stays the base latency, p99
    is controlled by (``tail_prob``, ``tail_mult``) — the knob pair behind
    the tail-latency sweep in benchmarks/paper_figures.py."""

    tail_prob: float = 0.05
    tail_mult: float = 8.0
    kind = "bimodal"

    def draw(self, rng: np.random.Generator, n: Optional[int] = None):
        if n is None:
            return self.tail_mult if float(rng.random()) < self.tail_prob \
                else 1.0
        u = rng.random(size=n)
        return np.where(u < self.tail_prob, self.tail_mult, 1.0)


# =========================================================================
# Fault plane
# =========================================================================
#: Per-request completion status codes carried out-of-band with every done
#: time (``FarMemoryModel.last_status`` / ``last_statuses``) and through the
#: engines' AMART into the scheduler. OK requests move data; ERROR is a
#: device NACK arriving at the normal completion time; TIMED_OUT is a
#: dropped request whose failure notice surfaces after ``timeout_mult``×
#: the base latency (or at the RetryPolicy's ``timeout_cycles`` bound).
STATUS_OK = 0
STATUS_ERROR = 1
STATUS_TIMED_OUT = 2


@dataclass(frozen=True)
class LinkFlap:
    """A transient outage window on a region's channel, in absolute core
    cycles. Requests *injected* inside ``[start_cycle, start_cycle +
    duration)`` are affected: ``mode="stall"`` holds their delivery in the
    channel's retry buffer until the window clears (completion shifts by
    the remaining outage; injection pipelining of later requests is
    unaffected, keeping the fault plane orthogonal to the pinned
    link-serialization chains), ``mode="error"`` NACKs them at their normal
    completion time."""

    start_cycle: float
    duration: float
    mode: str = "stall"

    @property
    def end(self) -> float:
        return self.start_cycle + self.duration


@dataclass(frozen=True)
class FaultModel:
    """Seeded per-region fault injection. Each request draws exactly one
    uniform from the region's dedicated fault stream (spawned from the
    region's RNG lineage, so the latency bitstream is untouched and batch
    fills equal sequential scalar draws): ``u < error_prob`` → ERROR,
    next ``drop_prob`` mass → TIMED_OUT (dropped; failure notice at
    ``timeout_mult``× base latency). ``flaps`` adds deterministic outage
    windows on top (no RNG). A region with no FaultModel draws nothing —
    zero-fault configs execute today's code paths bit-for-bit."""

    error_prob: float = 0.0
    drop_prob: float = 0.0
    timeout_mult: float = 8.0
    flaps: Tuple[LinkFlap, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "flaps", tuple(self.flaps))


def _validate_fault_model(fm: FaultModel, where: str) -> None:
    if fm.error_prob < 0.0 or fm.drop_prob < 0.0:
        raise ValueError(f"{where}: fault probabilities must be >= 0, got "
                         f"error_prob={fm.error_prob}, "
                         f"drop_prob={fm.drop_prob}")
    if fm.error_prob + fm.drop_prob > 1.0:
        raise ValueError(f"{where}: error_prob + drop_prob must be <= 1, "
                         f"got {fm.error_prob + fm.drop_prob}")
    if fm.timeout_mult <= 0.0:
        raise ValueError(f"{where}: timeout_mult must be > 0, got "
                         f"{fm.timeout_mult}")
    prev_end = None
    prev_name = None
    for fl in sorted(fm.flaps, key=lambda f: f.start_cycle):
        if fl.start_cycle < 0.0 or fl.duration <= 0.0:
            raise ValueError(f"{where}: LinkFlap needs start_cycle >= 0 and "
                             f"duration > 0, got start={fl.start_cycle}, "
                             f"duration={fl.duration}")
        if fl.mode not in ("stall", "error"):
            raise ValueError(f"{where}: LinkFlap mode must be 'stall' or "
                             f"'error', got {fl.mode!r}")
        if prev_end is not None and fl.start_cycle < prev_end:
            raise ValueError(f"{where}: overlapping outage windows "
                             f"[{fl.start_cycle}, {fl.end}) and "
                             f"{prev_name}; merge them")
        prev_end = fl.end
        prev_name = f"[{fl.start_cycle}, {fl.end})"


# =========================================================================
# Regions
# =========================================================================
@dataclass(frozen=True)
class FarMemoryRegion:
    """One address-range tier of a heterogeneous far memory.

    ``[start, start + size)`` is the far-memory address range served at this
    operating point. ``link`` names the injection channel: regions sharing a
    link name contend on one serialization point (shared channel);
    ``link=None`` gives the region a private link named after it. Requests
    must not straddle a region boundary (routed by start address, validated
    against the end — a straddle raises rather than silently misroutes).
    """

    name: str
    start: int
    size: int
    base_latency_cycles: float
    bandwidth_bytes_per_cycle: float = 21.3
    max_inflight: int = 0                 # 0 -> unlimited (link BW still caps)
    jitter_frac: float = 0.0              # legacy uniform ± fraction
    distribution: Optional[LatencyDistribution] = None
    link: Optional[str] = None
    faults: Optional[FaultModel] = None   # None -> this region never fails
    #: name of the region retry-exhausted requests re-route to (same far
    #: address, alternate path/replica): the scheduler's degradation mode.
    failover: Optional[str] = None

    @property
    def end(self) -> int:
        return self.start + self.size

    @classmethod
    def from_latency_us(cls, name: str, start: int, size: int,
                        lat_us: float, freq_ghz: float = 3.0,
                        bandwidth_gbs: float = 64.0, **kw) -> "FarMemoryRegion":
        return cls(name, start, size,
                   base_latency_cycles=lat_us * 1e3 * freq_ghz,
                   bandwidth_bytes_per_cycle=bandwidth_gbs / freq_ghz, **kw)


def _validate_regions(regions: Tuple[FarMemoryRegion, ...]) -> None:
    names = [r.name for r in regions]
    if len(set(names)) != len(names) or not all(names):
        raise ValueError(f"region names must be unique and non-empty: {names}")
    prev_end = None
    for r in regions:
        if r.size <= 0 or r.start < 0:
            raise ValueError(f"region {r.name!r}: need start >= 0 and "
                             f"size > 0, got [{r.start}, {r.end})")
        if r.base_latency_cycles < 0 or r.bandwidth_bytes_per_cycle <= 0:
            raise ValueError(f"region {r.name!r}: latency must be >= 0 and "
                             f"bandwidth > 0")
        if r.max_inflight < 0:
            raise ValueError(f"region {r.name!r}: max_inflight must be >= 0")
        if r.jitter_frac and r.distribution is not None:
            raise ValueError(f"region {r.name!r}: jitter_frac and "
                             f"distribution are two spellings of the same "
                             f"knob; set one")
        if prev_end is not None and r.start < prev_end:
            raise ValueError(f"regions must be ascending and non-overlapping;"
                             f" {r.name!r} starts at {r.start} before the "
                             f"previous region ends at {prev_end}")
        prev_end = r.end
        if r.faults is not None:
            _validate_fault_model(r.faults, f"region {r.name!r}")
    by_name = {r.name: r for r in regions}
    for r in regions:
        if r.failover is None:
            continue
        if r.failover == r.name:
            raise ValueError(f"region {r.name!r} fails over to itself")
        if r.failover not in by_name:
            raise ValueError(f"region {r.name!r} fails over to unknown "
                             f"region {r.failover!r} (have {names})")
        seen = [r.name]
        cur = r
        while cur.failover is not None:
            if cur.failover in seen:
                raise ValueError(
                    f"failover cycle: {' -> '.join(seen)} -> {cur.failover}")
            seen.append(cur.failover)
            cur = by_name[cur.failover]


@dataclass
class FarMemoryConfig:
    base_latency_cycles: float = 3000.0   # 1 us at 3 GHz
    bandwidth_bytes_per_cycle: float = 21.3  # ~64 GB/s CXL-ish at 3 GHz
    jitter_frac: float = 0.0              # uniform +- fraction of base latency
    max_inflight: int = 0                 # 0 -> unlimited (link BW still caps)
    seed: int = 0
    distribution: Optional[LatencyDistribution] = None
    #: heterogeneous mode: per-address-range tiers (empty -> flat model).
    #: The flat operating-point fields above are ignored when regions are
    #: set; each region carries its own. Region i draws from
    #: ``default_rng(seed + i)``, so a single region covering the address
    #: space reproduces the flat model bit-for-bit.
    regions: Tuple[FarMemoryRegion, ...] = ()
    #: flat-model fault injection (heterogeneous mode attaches a FaultModel
    #: per region instead).
    faults: Optional[FaultModel] = None

    def __post_init__(self) -> None:
        self.regions = tuple(self.regions)
        if self.regions:
            _validate_regions(self.regions)
            if self.faults is not None:
                raise ValueError("heterogeneous far memory takes faults per "
                                 "region (FarMemoryRegion.faults), not on "
                                 "the config")
        elif self.faults is not None:
            _validate_fault_model(self.faults, "far memory")
        if self.jitter_frac and self.distribution is not None:
            raise ValueError("jitter_frac and distribution are two spellings "
                             "of the same knob; set one")

    @classmethod
    def from_latency_us(cls, lat_us: float, freq_ghz: float = 3.0,
                        bandwidth_gbs: float = 64.0, **kw) -> "FarMemoryConfig":
        return cls(base_latency_cycles=lat_us * 1e3 * freq_ghz,
                   bandwidth_bytes_per_cycle=bandwidth_gbs / freq_ghz, **kw)


# =========================================================================
# Internal state helpers
# =========================================================================
class _Ledger:
    """Closed-form MLP ledger: completion times + sum of issue times.

    ``seq_sum`` optionally points at the jitted sequential accumulator
    (``host_jit``): same left-to-right binary adds, same bits.
    """

    __slots__ = ("dones", "n", "sum_issue", "seq_sum")

    def __init__(self, seq_sum=None) -> None:
        self.dones = np.empty(1024, np.float64)
        self.n = 0
        self.sum_issue = 0.0
        self.seq_sum = seq_sum

    def record(self, issue_t: float, done: float) -> None:
        if self.n == self.dones.size:
            self.dones = np.concatenate(
                [self.dones, np.empty(self.dones.size, np.float64)])
        self.dones[self.n] = done
        self.n += 1
        self.sum_issue += issue_t

    def record_batch(self, issue_t, done: np.ndarray) -> None:
        """Ledger-record a batch. `issue_t` is a scalar (all requests start
        counting at the same instant) or a per-request array (backpressured
        admission staggers the MSHR-occupancy start times)."""
        need = self.n + done.size
        if need > self.dones.size:
            grow = max(self.dones.size * 2, need)
            self.dones = np.concatenate(
                [self.dones[:self.n], np.empty(grow - self.n, np.float64)])
        self.dones[self.n:need] = done
        self.n = need
        if np.ndim(issue_t):
            # sequential adds keep the ledger bit-identical to n scalar
            # record() calls (np.sum's pairwise order differs in float)
            if self.seq_sum is not None:
                self.sum_issue = float(self.seq_sum(
                    np.asarray(issue_t, np.float64), self.sum_issue))
            else:
                for v in issue_t:
                    self.sum_issue += float(v)
        else:
            self.sum_issue += float(issue_t) * done.size

    def area(self, total_time: float) -> float:
        """Integral of the in-flight count over [0, total_time]."""
        a = (float(np.minimum(self.dones[:self.n], total_time).sum())
             - self.sum_issue)
        return max(a, 0.0)

    def inflight(self, now: float) -> int:
        return int((self.dones[:self.n] > now).sum())

    def clear(self) -> None:
        self.n = 0
        self.sum_issue = 0.0


class _Link:
    """A serialization point: the time the channel next becomes free.
    Regions sharing a link share one of these (shared-channel contention)."""

    __slots__ = ("free",)

    def __init__(self) -> None:
        self.free = 0.0


class _RegionState:
    """Mutable per-region runtime state (the flat model's fields, per tier)."""

    __slots__ = ("region", "link", "rng", "token", "inflight", "ledger",
                 "requests", "bytes_moved", "fault_rng", "errors", "timeouts",
                 "stalls")

    def __init__(self, region: FarMemoryRegion, link: _Link,
                 rng: np.random.Generator, seq_sum=None) -> None:
        self.region = region
        self.link = link
        self.rng = rng
        self.token = 0
        self.inflight: List[Tuple[float, int]] = []
        self.ledger = _Ledger(seq_sum)
        self.requests = 0
        self.bytes_moved = 0
        # dedicated fault stream, spawned from the region's RNG lineage:
        # deterministic per seed, and drawing from it never advances the
        # latency bitstream (zero-fault configs stay bit-identical)
        self.fault_rng = rng.spawn(1)[0] if region.faults is not None else None
        self.errors = 0
        self.timeouts = 0
        self.stalls = 0


class FarMemoryModel:
    """Timed far-memory device. All times in core cycles (float).

    ``host_jit=True`` swaps the sequential injection-chain / ledger
    recurrences for numba kernels when numba is importable (pure-numpy
    fallback otherwise) — results are bit-identical either way.
    """

    def __init__(self, config: FarMemoryConfig, host_jit: bool = False,
                 timeout_cycles: float = 0.0):
        self.config = config
        self.host_jit = bool(host_jit)
        self._jit_chain = hostjit.get_chain(self.host_jit)
        seq_sum = hostjit.get_seq_sum(self.host_jit)
        self._link_free = 0.0
        self._rng = np.random.default_rng(config.seed)
        self._token = 0
        self._ledger = _Ledger(seq_sum)
        # event heap, used only in max_inflight (backpressure) mode
        self._inflight: List[Tuple[float, int]] = []
        # stats
        self.requests = 0
        self.bytes_moved = 0
        # shared-device occupancy attribution: `client` tags the requester
        # currently issuing (the rack arbiter sets it to the core index
        # before stepping each core; single-core sessions leave it at 0)
        # and `link_busy` accumulates serialized channel cycles per
        # (link, client). Pure accounting — never feeds timing or RNG, so
        # traces/bitstreams are untouched by who (or whether anyone) reads
        # it. The flat (regionless) model charges one implicit "far" link.
        self.client = 0
        self.link_busy: Dict[str, Dict[int, float]] = {}
        # fault plane: requester-side timeout bound (RetryPolicy), flat-model
        # fault stream, counters, and the out-of-band status channel the
        # engines read right after each issue call. When fault_enabled is
        # False every fault branch below is skipped — zero-fault configs run
        # exactly the pre-fault code (bit-identical traces and bitstreams).
        self.timeout_cycles = float(timeout_cycles)
        self.fault_enabled = bool(
            self.timeout_cycles > 0.0
            or config.faults is not None
            or any(r.faults is not None for r in config.regions))
        self._fault_rng = (self._rng.spawn(1)[0]
                           if config.faults is not None else None)
        self._forced_region: Optional[int] = None   # failover route override
        self.errors = 0
        self.timeouts = 0
        self.stalls = 0
        self.last_status = STATUS_OK        # after issue(), in fault mode
        self.last_statuses: Optional[np.ndarray] = None  # after batch/epoch
        # heterogeneous mode: per-region state + address-routing arrays
        self._regions: Optional[List[_RegionState]] = None
        if config.regions:
            links: Dict[str, _Link] = {}
            self._regions = [
                _RegionState(r, links.setdefault(r.link or r.name, _Link()),
                             np.random.default_rng(config.seed + i), seq_sum)
                for i, r in enumerate(config.regions)]
            self._starts = np.array([r.start for r in config.regions],
                                    np.int64)
            self._ends = np.array([r.end for r in config.regions], np.int64)
            # reordering-path tables: per-region bandwidth / backpressure
            # flags and a dense link index (regions sharing a _Link share an
            # index), so a mixed batch routes to per-link chains without
            # touching Python objects per row
            self._links: List[_Link] = []
            link_ix: Dict[int, int] = {}
            lt = []
            for st in self._regions:
                ix = link_ix.setdefault(id(st.link), len(self._links))
                if ix == len(self._links):
                    self._links.append(st.link)
                lt.append(ix)
            self._link_table = np.array(lt, np.int64)
            self._bw_table = np.array(
                [r.bandwidth_bytes_per_cycle for r in config.regions],
                np.float64)
            self._mi_table = np.array(
                [r.max_inflight for r in config.regions], np.int64)

    # -- accounting ---------------------------------------------------------
    def inflight_at(self, now: float) -> int:
        """Requests issued at or before `now` that have not completed."""
        if self._regions is not None:
            return sum(self._region_inflight_at(st, now)
                       for st in self._regions)
        if self.config.max_inflight:
            while self._inflight and self._inflight[0][0] <= now:
                heapq.heappop(self._inflight)
            return len(self._inflight)
        return self._ledger.inflight(now)

    def avg_mlp(self, total_time: float) -> float:
        if self._regions is not None:
            area = sum(st.ledger.area(total_time) for st in self._regions)
        else:
            area = self._ledger.area(total_time)
        return area / max(total_time, 1e-9)

    def _charge_link(self, link: str, serial_cycles: float) -> None:
        by = self.link_busy.setdefault(link, {})
        by[self.client] = by.get(self.client, 0.0) + serial_cycles

    def link_occupancy(self, total_time: float) -> Dict[str, Dict]:
        """Per-link serialized-cycle totals and busy fraction over
        ``[0, total_time]``, with the per-client split (`by_client` keys are
        the requester tags — rack core indices). ``occupancy`` near 1.0
        means the channel itself is the bottleneck."""
        return {
            link: {
                "busy_cycles": sum(by.values()),
                "occupancy": sum(by.values()) / max(total_time, 1e-9),
                "by_client": dict(sorted(by.items())),
            } for link, by in sorted(self.link_busy.items())}

    def region_stats(self, total_time: float) -> Optional[Dict[str, Dict]]:
        """Per-region request/byte/MLP stats (None for the flat model)."""
        if self._regions is None:
            return None
        return {
            st.region.name: {
                "requests": st.requests,
                "bytes": st.bytes_moved,
                "mlp": st.ledger.area(total_time) / max(total_time, 1e-9),
                "latency_cycles": st.region.base_latency_cycles,
                "link": st.region.link or st.region.name,
                **({"errors": st.errors, "timeouts": st.timeouts}
                   if self.fault_enabled else {}),
            } for st in self._regions}

    # -- fault plane --------------------------------------------------------
    @property
    def faults_injected(self) -> int:
        return self.errors + self.timeouts

    def failover_index(self, addr: int) -> Optional[int]:
        """Region index the scheduler re-routes `addr` to after retry
        exhaustion (None when addr's home region has no failover)."""
        if self._regions is None:
            return None
        home = self._route(int(addr), 0)
        if home.region.failover is None:
            return None
        for i, st in enumerate(self._regions):
            if st.region.name == home.region.failover:
                return i
        return None

    def _fault_active(self, faults: Optional[FaultModel]) -> bool:
        return faults is not None or self.timeout_cycles > 0.0

    def _apply_faults(self, st: Optional[_RegionState], starts, injects,
                      serial, done):
        """Classify one chunk of requests and apply fault timing overrides.

        ``st`` is the owning region state (None for the flat model). Consumes
        exactly one uniform per request from the fault stream when the chunk
        carries fault probabilities — a stream separate from the latency
        stream, filled per chunk exactly like sequential scalar draws, so
        every existing bitstream identity survives. ERROR keeps normal
        timing (a NACK rides the response path); dropped requests surface
        TIMED_OUT at ``timeout_mult``× base latency; stall-flap windows
        defer delivery to the outage end; the requester-side
        ``timeout_cycles`` bound reclassifies anything slower than ``start +
        timeout_cycles``. Returns ``(done, status)`` — done possibly
        rewritten, status int8 per request. Link-free evolution is computed
        by the callers *before* this runs, so faults never perturb the
        pinned injection chains."""
        faults = st.region.faults if st is not None else self.config.faults
        n = done.size
        status = np.zeros(n, np.int8)
        if faults is not None:
            frng = st.fault_rng if st is not None else self._fault_rng
            psum = faults.error_prob + faults.drop_prob
            if psum > 0.0:
                u = frng.random(size=n)
                err = u < faults.error_prob
                drop = ~err & (u < psum)
                if err.any():
                    status[err] = STATUS_ERROR
                if drop.any():
                    status[drop] = STATUS_TIMED_OUT
                    done = np.where(
                        drop,
                        injects + serial + (st.region.base_latency_cycles
                                            if st is not None else
                                            self.config.base_latency_cycles)
                        * faults.timeout_mult,
                        done)
            for fl in faults.flaps:
                inwin = (injects >= fl.start_cycle) & (injects < fl.end)
                if not inwin.any():
                    continue
                hit = inwin & (status == STATUS_OK)
                if fl.mode == "error":
                    status[hit] = STATUS_ERROR
                else:       # stall: held in the retry buffer until it clears
                    done = np.where(hit, fl.end + (done - injects), done)
                    ns = int(hit.sum())
                    self.stalls += ns
                    if st is not None:
                        st.stalls += ns
        if self.timeout_cycles > 0.0:
            late = (status == STATUS_OK) \
                & (done - starts > self.timeout_cycles)
            if late.any():
                status[late] = STATUS_TIMED_OUT
                done = np.where(late, starts + self.timeout_cycles, done)
        ne = int((status == STATUS_ERROR).sum())
        nt = int((status == STATUS_TIMED_OUT).sum())
        if ne or nt:
            self.errors += ne
            self.timeouts += nt
            if st is not None:
                st.errors += ne
                st.timeouts += nt
        return done, status

    # -- request path -------------------------------------------------------
    def issue(self, now: float, size_bytes: int,
              addr: Optional[int] = None) -> float:
        """Issue a request at `now`; returns absolute completion time.
        `addr` routes to the owning region in heterogeneous mode (ignored
        by the flat model)."""
        if self._regions is not None:
            return self._region_issue(self._route(addr, size_bytes),
                                      now, size_bytes)
        cfg = self.config
        inject_at = max(now, self._link_free)
        start = now          # when the request starts counting as in flight
        if cfg.max_inflight and self.inflight_at(now) >= cfg.max_inflight:
            # device-side queue full: wait for the oldest completion; the
            # request only occupies an MSHR (counts toward MLP) from then
            oldest = self._inflight[0][0]
            inject_at = max(inject_at, oldest)
            self.inflight_at(inject_at)
            start = inject_at
        serial = size_bytes / cfg.bandwidth_bytes_per_cycle
        self._link_free = inject_at + serial
        self._charge_link("far", serial)
        lat = cfg.base_latency_cycles
        if cfg.distribution is not None:
            lat *= cfg.distribution.draw(self._rng)
        elif cfg.jitter_frac:
            lat *= 1.0 + cfg.jitter_frac * float(self._rng.uniform(-1.0, 1.0))
        done = inject_at + serial + lat
        if self.fault_enabled:
            d1, s1 = self._apply_faults(None, start, np.array([inject_at]),
                                        np.array([serial]), np.array([done]))
            done = float(d1[0])
            self.last_status = int(s1[0])
        if cfg.max_inflight:
            self._token += 1
            heapq.heappush(self._inflight, (done, self._token))
        self._ledger.record(start, done)
        self.requests += 1
        self.bytes_moved += size_bytes
        return done

    def issue_batch(self, now: float, sizes: "np.ndarray",
                    addrs: Optional["np.ndarray"] = None) -> "np.ndarray":
        """Vectorized :meth:`issue`: n requests injected back-to-back at `now`.

        Trace-identical to n sequential ``issue(now, size, addr)`` calls —
        link serialization is a prefix sum over the per-request injection
        spacing, and latency draws consume each RNG bitstream exactly like n
        scalar draws. In heterogeneous mode the batch is processed as
        consecutive same-region runs (each vectorized against its region's
        link/RNG), which reproduces the scalar loop's cross-region link and
        RNG interleaving bit-for-bit.
        """
        sizes = np.asarray(sizes, dtype=np.float64)
        n = sizes.size
        if n == 0:
            return np.empty(0, np.float64)
        status = np.zeros(n, np.int8) if self.fault_enabled else None
        if status is not None:
            self.last_statuses = status
        if self._regions is not None:
            return self._region_issue_batch_routed(now, sizes, addrs, status)
        cfg = self.config
        if cfg.max_inflight:
            return self._issue_batch_backpressured(now, sizes, status)
        serial = sizes / cfg.bandwidth_bytes_per_cycle
        inject0 = max(now, self._link_free)
        # cumsum over [inject0, s0, s1, ...] reproduces the scalar loop's
        # left-to-right link_free accumulation bit-for-bit
        injects = np.empty(n, np.float64)
        injects[0] = inject0
        injects[1:] = serial[:-1]
        np.cumsum(injects, out=injects)
        if cfg.distribution is not None:
            lat = cfg.base_latency_cycles * cfg.distribution.draw(self._rng, n)
            done = injects + serial + lat
        elif cfg.jitter_frac:
            lat = cfg.base_latency_cycles * (
                1.0 + cfg.jitter_frac * self._rng.uniform(-1.0, 1.0, size=n))
            done = injects + serial + lat
        else:
            # scalar broadcast == np.full(n, lat) elementwise, bit-for-bit
            done = injects + serial + cfg.base_latency_cycles
        self._link_free = float(injects[-1]) + float(serial[-1])
        self._charge_link("far", float(serial.sum()))
        if status is not None:
            done, status[:] = self._apply_faults(None, now, injects, serial,
                                                 done)
        self._ledger.record_batch(now, done)
        self.requests += n
        self.bytes_moved += int(sizes.sum())
        return done

    def _issue_batch_backpressured(self, now: float, sizes: "np.ndarray",
                                   status_out=None) -> "np.ndarray":
        """`issue_batch` under ``max_inflight``: chunked admission against the
        completion heap, time-identical to n sequential :meth:`issue` calls.

        The scalar loop admits requests freely while the device queue has
        room (each occupies an MSHR from `now`), then couples injection to
        completions: a backpressured request waits for the oldest in-flight
        completion, and the pop at its injection time may retire *several*
        entries, opening room for another admission burst. We replay exactly
        that alternation, but each admission burst computes its
        link-serialized injection times, latency draws, and ledger records
        as one vector chunk instead of one Python call per request.
        """
        cfg = self.config
        hp = self._inflight
        n = sizes.size
        serial = sizes / cfg.bandwidth_bytes_per_cycle
        dones = np.empty(n, np.float64)
        starts = np.empty(n, np.float64)
        i = 0
        while i < n:
            # the scalar loop calls inflight_at(now) before every admission
            while hp and hp[0][0] <= now:
                heapq.heappop(hp)
            room = cfg.max_inflight - len(hp)
            if room > 0:
                # admission burst: k requests inject back-to-back from
                # link_free; each counts as in flight from `now`
                k = min(room, n - i)
                chunk = serial[i:i + k]
                inject0 = max(now, self._link_free)
                # same association as the scalar link_free chain (see above)
                injects = np.cumsum(np.concatenate([[inject0], chunk[:-1]]))
                lat = np.full(k, cfg.base_latency_cycles)
                if cfg.distribution is not None:
                    lat = lat * cfg.distribution.draw(self._rng, k)
                elif cfg.jitter_frac:
                    lat *= 1.0 + cfg.jitter_frac * self._rng.uniform(
                        -1.0, 1.0, size=k)
                dk = injects + chunk + lat
                self._link_free = float(injects[-1]) + float(chunk[-1])
                if status_out is not None:
                    dk, status_out[i:i + k] = self._apply_faults(
                        None, now, injects, chunk, dk)
                for d in dk:
                    self._token += 1
                    heapq.heappush(hp, (float(d), self._token))
                dones[i:i + k] = dk
                starts[i:i + k] = now
                i += k
            else:
                # queue full: wait for the oldest completion; the pop at the
                # injection time may drain several entries (next loop turn
                # then takes the admission-burst branch)
                inject_at = max(now, self._link_free, hp[0][0])
                while hp and hp[0][0] <= inject_at:
                    heapq.heappop(hp)
                lat = cfg.base_latency_cycles
                if cfg.distribution is not None:
                    lat *= cfg.distribution.draw(self._rng)
                elif cfg.jitter_frac:
                    lat *= 1.0 + cfg.jitter_frac * float(
                        self._rng.uniform(-1.0, 1.0))
                d = inject_at + float(serial[i]) + lat
                self._link_free = inject_at + float(serial[i])
                if status_out is not None:
                    d1, s1 = self._apply_faults(
                        None, inject_at, np.array([inject_at]),
                        np.array([float(serial[i])]), np.array([d]))
                    d = float(d1[0])
                    status_out[i] = s1[0]
                self._token += 1
                heapq.heappush(hp, (d, self._token))
                dones[i] = d
                starts[i] = inject_at
                i += 1
        self._charge_link("far", float(serial.sum()))
        self._ledger.record_batch(starts, dones)
        self.requests += n
        self.bytes_moved += int(sizes.sum())
        return dones

    # -- heterogeneous (regioned) request path ------------------------------
    def _route(self, addr: Optional[int], size: int) -> _RegionState:
        if self._forced_region is not None:
            # failover re-issue: alternate path/replica serving the same far
            # address — range checks are the home region's concern
            return self._regions[self._forced_region]
        if addr is None:
            raise ValueError("heterogeneous far memory routes by address; "
                             "issue() needs addr")
        i = int(np.searchsorted(self._starts, addr, side="right")) - 1
        if i < 0 or addr >= self._ends[i]:
            raise ValueError(f"address {addr} outside configured far-memory "
                             f"regions")
        if addr + size > self._ends[i]:
            r = self._regions[i].region
            raise ValueError(f"request [{addr}, {addr + size}) straddles "
                             f"region {r.name!r} ending at {r.end}")
        return self._regions[i]

    def _region_inflight_at(self, st: _RegionState, now: float) -> int:
        if st.region.max_inflight:
            while st.inflight and st.inflight[0][0] <= now:
                heapq.heappop(st.inflight)
            return len(st.inflight)
        return st.ledger.inflight(now)

    def _region_lat(self, st: _RegionState, n: Optional[int] = None):
        """Latency draw(s) for one region — scalar/batch bit-identical."""
        r = st.region
        lat = r.base_latency_cycles
        if r.distribution is not None:
            return lat * r.distribution.draw(st.rng, n)
        if r.jitter_frac:
            if n is None:
                return lat * (1.0 + r.jitter_frac
                              * float(st.rng.uniform(-1.0, 1.0)))
            return lat * (1.0 + r.jitter_frac
                          * st.rng.uniform(-1.0, 1.0, size=n))
        return lat if n is None else np.full(n, lat)

    def _region_issue(self, st: _RegionState, now: float, size: int) -> float:
        r = st.region
        inject_at = max(now, st.link.free)
        start = now
        if r.max_inflight and self._region_inflight_at(st, now) \
                >= r.max_inflight:
            oldest = st.inflight[0][0]
            inject_at = max(inject_at, oldest)
            self._region_inflight_at(st, inject_at)
            start = inject_at
        serial = size / r.bandwidth_bytes_per_cycle
        st.link.free = inject_at + serial
        self._charge_link(r.link or r.name, serial)
        done = inject_at + serial + self._region_lat(st)
        if self.fault_enabled:
            if self._fault_active(r.faults):
                d1, s1 = self._apply_faults(
                    st, start, np.array([inject_at]), np.array([serial]),
                    np.array([done]))
                done = float(d1[0])
                self.last_status = int(s1[0])
            else:
                self.last_status = STATUS_OK
        if r.max_inflight:
            st.token += 1
            heapq.heappush(st.inflight, (done, st.token))
        st.ledger.record(start, done)
        st.requests += 1
        st.bytes_moved += size
        self.requests += 1
        self.bytes_moved += size
        return done

    def _route_batch(self, sizes: np.ndarray, addrs) -> np.ndarray:
        """Vectorized routing + validation: region index per row."""
        if addrs is None:
            raise ValueError("heterogeneous far memory routes by address; "
                             "issue_batch() needs addrs")
        addrs = np.asarray(addrs, np.int64)
        idx = np.searchsorted(self._starts, addrs, side="right") - 1
        safe = np.clip(idx, 0, len(self._regions) - 1)
        bad = ((idx < 0) | (addrs >= self._ends[safe])
               | (addrs + sizes.astype(np.int64) > self._ends[safe]))
        if bad.any():
            # re-raise through the scalar validator for the precise message
            b = int(np.argmax(bad))
            self._route(int(addrs[b]), int(sizes[b]))
        return idx

    def _region_issue_batch_routed(self, now: float, sizes: np.ndarray,
                                   addrs, status_out=None) -> np.ndarray:
        idx = self._route_batch(sizes, addrs)
        n = sizes.size
        involved = np.unique(idx)
        if involved.size > 1 and not self._mi_table[involved].any():
            # mixed-tier reordering path: arbitrary interleavings of
            # unlimited regions vectorize as per-link chains + per-region
            # draws (bit-identical to the scalar loop; see issue_epoch)
            return self._fused_routed(np.array([now], np.float64),
                                      np.array([0, n], np.int64), sizes, idx,
                                      status_out)
        dones = np.empty(n, np.float64)
        i = 0
        while i < n:                    # consecutive same-region runs
            j = i + 1
            while j < n and idx[j] == idx[i]:
                j += 1
            st = self._regions[int(idx[i])]
            sub = status_out[i:j] if status_out is not None else None
            if st.region.max_inflight:
                dones[i:j] = self._region_batch_backpressured(
                    st, now, sizes[i:j], sub)
            else:
                dones[i:j] = self._region_batch(st, now, sizes[i:j], sub)
            i = j
        return dones

    def _chain_inject(self, seg_nows, seg_bounds, serial, link_ids,
                      free) -> np.ndarray:
        """Per-link injection chains across segments, in row order.

        ``free`` is a float64 array of per-link next-free times, updated in
        place. Bit-identical to the scalar per-row recurrence
        ``inj = max(now_seg(i), free[l_i]); free[l_i] = inj + serial_i``:
        within one (segment, link) chunk the link's free time can only stay
        at/above that segment's `now` after the first row, so the inner rows
        collapse to the same left-to-right ``np.cumsum`` the single-region
        batch path uses. The jitted kernel runs the recurrence directly —
        same sequential binary ops, same bits.
        """
        n = serial.size
        injects = np.empty(n, np.float64)
        if self._jit_chain is not None:
            nows_row = np.repeat(seg_nows, np.diff(seg_bounds))
            self._jit_chain(nows_row, serial, link_ids, free, injects)
            return injects
        if free.size == 1:
            # single link (flat model, or all regions on one channel): the
            # per-link grouping is the identity, so each segment is one
            # contiguous cumsum chunk
            f = float(free[0])
            for s in range(seg_nows.size):
                lo, hi = int(seg_bounds[s]), int(seg_bounds[s + 1])
                if lo == hi:
                    continue
                inj = injects[lo:hi]
                inj[0] = max(float(seg_nows[s]), f)
                inj[1:] = serial[lo:hi - 1]
                np.cumsum(inj, out=inj)
                f = float(inj[-1]) + float(serial[hi - 1])
            free[0] = f
            return injects
        for s in range(seg_nows.size):
            lo, hi = int(seg_bounds[s]), int(seg_bounds[s + 1])
            if lo == hi:
                continue
            now_s = float(seg_nows[s])
            seg_links = link_ids[lo:hi]
            for ix in np.unique(seg_links):
                rows = lo + np.flatnonzero(seg_links == ix)
                ser = serial[rows]
                inj = np.empty(rows.size, np.float64)
                inj[0] = max(now_s, float(free[ix]))
                inj[1:] = ser[:-1]
                np.cumsum(inj, out=inj)
                injects[rows] = inj
                free[ix] = float(inj[-1]) + float(ser[-1])
        return injects

    def _fused_routed_small(self, seg_nows, seg_bounds, sizes,
                            idx, status_out=None) -> np.ndarray:
        """`_fused_routed` for a handful of rows (serving epochs under
        open-loop arrivals carry ~4): the same factoring run as Python
        loops, skipping the unique/flatnonzero machinery whose fixed cost
        dominates at this scale. Bit-identical — draws happen in the same
        ascending-region order with the same chunk counts, the per-link
        injection recurrence is the same sequence of float ops the cumsum
        chunks reduce to, and ledger/stat chunks keep the per-(segment,
        region) association."""
        n = sizes.size
        il = idx.tolist()
        serial = sizes / self._bw_table[idx]
        lat = np.empty(n, np.float64)
        for ri in sorted(set(il)):
            rows = [i for i, r in enumerate(il) if r == ri]
            lat[rows] = self._region_lat(self._regions[ri], len(rows))
            r = self._regions[ri].region
            self._charge_link(r.link or r.name, float(serial[rows].sum()))
        links = self._link_table[idx].tolist()
        free = {ix: float(l.free) for ix, l in enumerate(self._links)}
        injects = np.empty(n, np.float64)
        bounds = seg_bounds.tolist()
        nows = seg_nows.tolist()
        for s in range(len(nows)):
            now_s = nows[s]
            for i in range(bounds[s], bounds[s + 1]):
                ix = links[i]
                inj = free[ix]
                if now_s > inj:
                    inj = now_s
                injects[i] = inj
                free[ix] = inj + float(serial[i])
        for ix, l in enumerate(self._links):
            l.free = free[ix]
        done = injects + serial + lat
        if status_out is not None:
            nows_row = np.repeat(seg_nows, np.diff(seg_bounds))
            for ri in sorted(set(il)):
                st = self._regions[ri]
                if not self._fault_active(st.region.faults):
                    continue
                rows = np.array([i for i, r in enumerate(il) if r == ri])
                d2, s2 = self._apply_faults(st, nows_row[rows], injects[rows],
                                            serial[rows], done[rows])
                done[rows] = d2
                status_out[rows] = s2
        for s in range(len(nows)):
            lo, hi = bounds[s], bounds[s + 1]
            if lo == hi:
                continue
            seg = il[lo:hi]
            for ri in sorted(set(seg)):
                rows = [lo + i for i, r in enumerate(seg) if r == ri]
                st = self._regions[ri]
                st.ledger.record_batch(nows[s], done[rows])
                nb = int(sizes[rows].sum())
                st.requests += len(rows)
                st.bytes_moved += nb
                self.requests += len(rows)
                self.bytes_moved += nb
        return done

    def _fused_routed(self, seg_nows, seg_bounds, sizes,
                      idx, status_out=None) -> np.ndarray:
        """Reordered mixed-tier issue over unlimited regions.

        The scalar loop's per-row work factors exactly: latency draws only
        touch the row's region RNG (per-region fills in row order consume
        each bitstream identically), injection only touches the row's link
        (per-link chains in row order reproduce the interleaved link_free
        evolution), and nothing couples to completions (no backpressure).
        Ledger/stat updates chunk per (segment, region) to mirror the
        per-command batch path's float association.
        """
        n = sizes.size
        if n <= 16 and self._jit_chain is None:
            return self._fused_routed_small(seg_nows, seg_bounds, sizes, idx,
                                            status_out)
        serial = sizes / self._bw_table[idx]
        lat = np.empty(n, np.float64)
        for ri in np.unique(idx):
            rows = np.flatnonzero(idx == ri)
            lat[rows] = self._region_lat(self._regions[int(ri)], rows.size)
            r = self._regions[int(ri)].region
            self._charge_link(r.link or r.name, float(serial[rows].sum()))
        free = np.array([l.free for l in self._links], np.float64)
        injects = self._chain_inject(seg_nows, seg_bounds, serial,
                                     self._link_table[idx], free)
        for ix, link in enumerate(self._links):
            link.free = float(free[ix])
        done = injects + serial + lat
        if status_out is not None:
            nows_row = np.repeat(seg_nows, np.diff(seg_bounds))
            for ri in np.unique(idx):
                st = self._regions[int(ri)]
                if not self._fault_active(st.region.faults):
                    continue
                rows = np.flatnonzero(idx == ri)
                d2, s2 = self._apply_faults(st, nows_row[rows], injects[rows],
                                            serial[rows], done[rows])
                done[rows] = d2
                status_out[rows] = s2
        for s in range(seg_nows.size):
            lo, hi = int(seg_bounds[s]), int(seg_bounds[s + 1])
            if lo == hi:
                continue
            now_s = float(seg_nows[s])
            seg_idx = idx[lo:hi]
            for ri in np.unique(seg_idx):
                rows = lo + np.flatnonzero(seg_idx == ri)
                st = self._regions[int(ri)]
                st.ledger.record_batch(now_s, done[rows])
                nb = int(sizes[rows].sum())
                st.requests += rows.size
                st.bytes_moved += nb
                self.requests += rows.size
                self.bytes_moved += nb
        return done

    def _fused_flat(self, seg_nows, seg_bounds, sizes,
                    status_out=None) -> np.ndarray:
        """Epoch-fused issue against the flat (regionless) unlimited model."""
        cfg = self.config
        n = sizes.size
        serial = sizes / cfg.bandwidth_bytes_per_cycle
        free = np.array([self._link_free], np.float64)
        injects = self._chain_inject(seg_nows, seg_bounds, serial,
                                     np.zeros(n, np.int64), free)
        self._link_free = float(free[0])
        self._charge_link("far", float(serial.sum()))
        if cfg.distribution is not None:
            lat = cfg.base_latency_cycles * cfg.distribution.draw(self._rng, n)
            done = injects + serial + lat
        elif cfg.jitter_frac:
            lat = cfg.base_latency_cycles * (
                1.0 + cfg.jitter_frac * self._rng.uniform(-1.0, 1.0, size=n))
            done = injects + serial + lat
        else:
            done = injects + serial + cfg.base_latency_cycles
        if status_out is not None:
            nows_row = np.repeat(seg_nows, np.diff(seg_bounds))
            done, status_out[:] = self._apply_faults(None, nows_row, injects,
                                                     serial, done)
        for s in range(seg_nows.size):
            lo, hi = int(seg_bounds[s]), int(seg_bounds[s + 1])
            if lo != hi:
                self._ledger.record_batch(float(seg_nows[s]), done[lo:hi])
        self.requests += n
        self.bytes_moved += int(sizes.sum())
        return done

    def issue_epoch(self, seg_nows, seg_bounds, sizes,
                    addrs=None) -> np.ndarray:
        """One far-memory entry for a whole scheduler epoch of batches.

        ``seg_bounds`` (length S+1) partitions the rows into S segments;
        segment s was issued at ``seg_nows[s]``. Bit-identical to calling
        ``issue_batch(seg_nows[s], sizes[lo:hi], addrs[lo:hi])`` once per
        segment: fully fused when nothing the epoch touches is
        backpressured, otherwise an exact per-segment replay (injection
        under ``max_inflight`` is coupled to completions through a heap,
        which no reordering can untangle).
        """
        sizes = np.asarray(sizes, np.float64)
        seg_nows = np.asarray(seg_nows, np.float64)
        seg_bounds = np.asarray(seg_bounds, np.int64)
        n = sizes.size
        if n == 0:
            return np.empty(0, np.float64)
        status = np.zeros(n, np.int8) if self.fault_enabled else None
        if status is not None:
            self.last_statuses = status
        if self._regions is not None:
            addrs = np.asarray(addrs, np.int64) if addrs is not None else None
            idx = self._route_batch(sizes, addrs)
            if not self._mi_table[np.unique(idx)].any():
                return self._fused_routed(seg_nows, seg_bounds, sizes, idx,
                                          status)
            out = np.empty(n, np.float64)
            for s in range(seg_nows.size):
                lo, hi = int(seg_bounds[s]), int(seg_bounds[s + 1])
                if lo != hi:
                    out[lo:hi] = self._region_issue_batch_routed(
                        float(seg_nows[s]), sizes[lo:hi], addrs[lo:hi],
                        status[lo:hi] if status is not None else None)
            return out
        if self.config.max_inflight:
            out = np.empty(n, np.float64)
            for s in range(seg_nows.size):
                lo, hi = int(seg_bounds[s]), int(seg_bounds[s + 1])
                if lo != hi:
                    out[lo:hi] = self._issue_batch_backpressured(
                        float(seg_nows[s]), sizes[lo:hi],
                        status[lo:hi] if status is not None else None)
            return out
        return self._fused_flat(seg_nows, seg_bounds, sizes, status)

    def _region_batch(self, st: _RegionState, now: float,
                      sizes: np.ndarray, status_out=None) -> np.ndarray:
        """Unlimited-mode vector issue against one region (flat-path math)."""
        r = st.region
        n = sizes.size
        serial = sizes / r.bandwidth_bytes_per_cycle
        injects = np.empty(n, np.float64)
        injects[0] = max(now, st.link.free)
        injects[1:] = serial[:-1]
        np.cumsum(injects, out=injects)
        done = injects + serial + self._region_lat(st, n)
        st.link.free = float(injects[-1]) + float(serial[-1])
        self._charge_link(r.link or r.name, float(serial.sum()))
        if status_out is not None and self._fault_active(r.faults):
            done, status_out[:] = self._apply_faults(st, now, injects, serial,
                                                     done)
        st.ledger.record_batch(now, done)
        st.requests += n
        st.bytes_moved += int(sizes.sum())
        self.requests += n
        self.bytes_moved += int(sizes.sum())
        return done

    def _region_batch_backpressured(self, st: _RegionState, now: float,
                                    sizes: np.ndarray,
                                    status_out=None) -> np.ndarray:
        """Backpressured vector issue against one region: the flat chunked
        admission replayed against the region's heap/link/RNG."""
        r = st.region
        hp = st.inflight
        n = sizes.size
        if status_out is not None and not self._fault_active(r.faults):
            status_out = None           # nothing to classify for this region
        serial = sizes / r.bandwidth_bytes_per_cycle
        dones = np.empty(n, np.float64)
        starts = np.empty(n, np.float64)
        i = 0
        while i < n:
            while hp and hp[0][0] <= now:
                heapq.heappop(hp)
            room = r.max_inflight - len(hp)
            if room > 0:
                k = min(room, n - i)
                chunk = serial[i:i + k]
                inject0 = max(now, st.link.free)
                injects = np.cumsum(np.concatenate([[inject0], chunk[:-1]]))
                dk = injects + chunk + self._region_lat(st, k)
                st.link.free = float(injects[-1]) + float(chunk[-1])
                if status_out is not None:
                    dk, status_out[i:i + k] = self._apply_faults(
                        st, now, injects, chunk, dk)
                for d in dk:
                    st.token += 1
                    heapq.heappush(hp, (float(d), st.token))
                dones[i:i + k] = dk
                starts[i:i + k] = now
                i += k
            else:
                inject_at = max(now, st.link.free, hp[0][0])
                while hp and hp[0][0] <= inject_at:
                    heapq.heappop(hp)
                d = inject_at + float(serial[i]) + self._region_lat(st)
                st.link.free = inject_at + float(serial[i])
                if status_out is not None:
                    d1, s1 = self._apply_faults(
                        st, inject_at, np.array([inject_at]),
                        np.array([float(serial[i])]), np.array([d]))
                    d = float(d1[0])
                    status_out[i] = s1[0]
                st.token += 1
                heapq.heappush(hp, (d, st.token))
                dones[i] = d
                starts[i] = inject_at
                i += 1
        self._charge_link(r.link or r.name, float(serial.sum()))
        st.ledger.record_batch(starts, dones)
        st.requests += n
        st.bytes_moved += int(sizes.sum())
        self.requests += n
        self.bytes_moved += int(sizes.sum())
        return dones

    def reset_stats(self) -> None:
        """Zero the request/byte/MLP counters AND the queueing state: link
        serialization points, backpressure heaps, and token counters all
        clear, so a measured phase after a warmup starts from an idle device
        instead of inheriting the warmup's link occupancy (requests in
        flight at the reset stop contributing to MLP — the ledger is
        cleared). The RNG streams deliberately continue (resetting them
        would replay the warmup's latency draws) — the fault streams too,
        for the same reason — but all fault counters and the out-of-band
        status channel clear, so prepare-phase faults can't leak into a
        measured execute() split."""
        self.requests = 0
        self.bytes_moved = 0
        self.link_busy.clear()
        self._ledger.clear()
        self._link_free = 0.0
        self._inflight.clear()
        self._token = 0
        self.errors = 0
        self.timeouts = 0
        self.stalls = 0
        self.last_status = STATUS_OK
        self.last_statuses = None
        if self._regions is not None:
            for st in self._regions:
                st.requests = 0
                st.bytes_moved = 0
                st.ledger.clear()
                st.inflight.clear()
                st.token = 0
                st.link.free = 0.0
                st.errors = 0
                st.timeouts = 0
                st.stalls = 0


class InstantMemory(FarMemoryModel):
    """Zero-latency functional mode (used when the engine is an oracle)."""

    def __init__(self) -> None:
        super().__init__(FarMemoryConfig(base_latency_cycles=0.0,
                                         bandwidth_bytes_per_cycle=float("inf")))

    def issue(self, now: float, size_bytes: int,
              addr: Optional[int] = None) -> float:
        self.requests += 1
        self.bytes_moved += size_bytes
        return now

    def issue_batch(self, now: float, sizes: "np.ndarray",
                    addrs: Optional["np.ndarray"] = None) -> "np.ndarray":
        sizes = np.asarray(sizes)
        self.requests += sizes.size
        self.bytes_moved += int(sizes.sum()) if sizes.size else 0
        return np.full(sizes.size, now, np.float64)

    def issue_epoch(self, seg_nows, seg_bounds, sizes,
                    addrs=None) -> "np.ndarray":
        sizes = np.asarray(sizes)
        self.requests += sizes.size
        self.bytes_moved += int(sizes.sum()) if sizes.size else 0
        return np.repeat(np.asarray(seg_nows, np.float64),
                         np.diff(np.asarray(seg_bounds, np.int64)))
