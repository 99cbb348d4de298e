"""`AmuSession` — one object owning engine + scheduler + far-memory
lifecycle, with ``session.run(port) -> RunStats``.

The session replaces the ad-hoc build-engine-build-scheduler-run-drain
choreography that used to be copy-pasted between ``run_amu``, the benchmark
drivers and the test suites::

    from repro_torch.amu import AmuConfig, AmuSession

    with AmuSession(AmuConfig(engine="batched", vector=True)) as s:
        stats = s.run("GUPS")            # registered workload by name
        assert stats.verified
        mem = s.engine.mem               # engine/far/instance stay inspectable

``run`` accepts a registered workload name or any prebuilt
:class:`~repro_torch.amu.registry.Port` (e.g. a ``WorkloadInstance`` built with
custom knobs). Frontier-parallel ports (BFS) are driven level-
synchronously; everything else runs straight through the scheduler. After
each run the engine is drained and its ID-conservation invariants checked.
``run`` = :meth:`AmuSession.prepare` (build the stack) +
:meth:`AmuSession.execute` (drive it) — benchmarks use the split form to
keep construction out of their timed region.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import time

from dataclasses import dataclass, field, fields

import numpy as np

from repro_torch.amu.config import FREQ_GHZ, AmuConfig
from repro_torch.amu.registry import REGISTRY, Port, WorkloadRegistry
from repro_torch.core.coroutines import SCHEDULER_KINDS
from repro_torch.core.disambiguation import CuckooAddressSet
from repro_torch.core.engine import make_engine
from repro_torch.core.farmem import FarMemoryModel
from repro_torch.core.rack import RackArbiter


@dataclass(frozen=True)
class RunStats:
    """Typed result of one :meth:`AmuSession.run` (plus dict-style reads
    for the pre-session callers that indexed the old stats dict).

    ``regions`` carries per-tier request/byte/MLP stats when the config's
    far memory is heterogeneous (``AmuConfig(far=[...regions...])``), and
    is ``None`` for the flat model.

    ``faults_injected`` / ``retries`` / ``timeouts`` / ``failovers`` /
    ``availability`` report the fault plane: device-side fault draws, the
    retry/failover traffic the scheduler re-issued, and the fraction of
    logical requests that ultimately succeeded. Zero-fault configs keep
    the defaults (all-zero, availability 1.0).

    The ``req_*`` fields carry per-request completion-latency percentiles
    (µs) for request-level ports — those whose instance fills
    ``request_latency_cycles`` (the serving workload); ``None`` elsewhere.

    ``engine_entries`` / ``rows_per_entry`` / ``us_per_entry`` are host-side
    observability counters (how many times the run crossed the Python-level
    AMI surface, how many request rows the average crossing carried, and
    wall-clock µs of driver time per crossing). The first two are
    deterministic model facts; ``us_per_entry`` is wall-clock and excluded
    from equality comparisons.
    """
    cycles: float
    insts: float
    ipc: float
    mlp: float
    requests: int
    bytes: int
    disamb_cycles: float
    disamb_frac: float
    us: float
    units: int
    vector: bool
    verified: Optional[bool]
    workload: str = ""
    regions: Optional[Dict[str, Dict[str, float]]] = None
    faults_injected: int = 0
    retries: int = 0
    timeouts: int = 0
    failovers: int = 0
    availability: float = 1.0
    req_count: Optional[int] = None
    req_mean_us: Optional[float] = None
    req_p50_us: Optional[float] = None
    req_p99_us: Optional[float] = None
    req_p999_us: Optional[float] = None
    engine_entries: Optional[int] = None
    rows_per_entry: Optional[float] = None
    us_per_entry: Optional[float] = field(default=None, compare=False)

    # mapping-style access keeps old dict-consumer code working unchanged;
    # only COMPARABLE field names are keys (method names like "keys" stay
    # invisible, exactly as on the old plain dict, and wall-clock fields
    # stay out so to_dict() equality remains a model-identity check —
    # matching dataclass __eq__, which honors compare=False)
    def __getitem__(self, key: str):
        if key in self.keys():
            return getattr(self, key)
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self.keys()

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def keys(self):
        return [f.name for f in fields(self) if f.compare]

    def get(self, key: str, default=None):
        return getattr(self, key) if key in self.keys() else default

    def to_dict(self) -> Dict[str, object]:
        return {f.name: getattr(self, f.name) for f in fields(self)
                if f.compare}


def _request_latency_fields(lat_cycles) -> Dict[str, object]:
    """RunStats ``req_*`` kwargs from an instance's per-request completion
    latencies (cycles; negative entries mean the request never completed
    and are excluded). Empty dict of Nones when the port is not
    request-level."""
    none = dict(req_count=None, req_mean_us=None, req_p50_us=None,
                req_p99_us=None, req_p999_us=None)
    if lat_cycles is None:
        return none
    lat = np.asarray(lat_cycles, dtype=float)
    lat = lat[lat >= 0.0]
    if lat.size == 0:
        return none
    us = lat / (FREQ_GHZ * 1e3)
    p50, p99, p999 = np.quantile(us, [0.5, 0.99, 0.999])
    return dict(req_count=int(lat.size), req_mean_us=float(us.mean()),
                req_p50_us=float(p50), req_p99_us=float(p99),
                req_p999_us=float(p999))


def _stats_from_summary(stats: Dict[str, object], cfg: AmuConfig, inst: Port,
                        eng, use_vector: bool, regions,
                        entries: int, rows: int,
                        wall_us: float) -> RunStats:
    """Build a :class:`RunStats` from a scheduler ``summary()`` dict (the
    shared tail of :meth:`AmuSession.execute`, reused per rack core —
    callers that attribute shared-device counters per core patch the dict
    before handing it over)."""
    req = _request_latency_fields(
        getattr(inst, "request_latency_cycles", None))
    return RunStats(
        cycles=stats["cycles"], insts=stats["insts"], ipc=stats["ipc"],
        mlp=stats["mlp"], requests=stats["requests"],
        bytes=stats["bytes"], disamb_cycles=stats["disamb_cycles"],
        disamb_frac=stats["disamb_frac"],
        us=stats["cycles"] / (FREQ_GHZ * 1e3),
        units=inst.units, vector=use_vector,
        verified=bool(inst.verify(eng.mem)) if cfg.verify else None,
        workload=inst.name,
        regions=regions,
        faults_injected=stats.get("faults_injected", 0),
        retries=stats.get("retries", 0),
        timeouts=stats.get("timeouts", 0),
        failovers=stats.get("failovers", 0),
        availability=stats.get("availability", 1.0),
        engine_entries=entries,
        rows_per_entry=rows / entries if entries else 0.0,
        us_per_entry=wall_us / entries if entries else 0.0, **req)


class AmuSession:
    """Context manager owning one AMU execution stack.

    Holds the :class:`AmuConfig`; each :meth:`run` builds the far-memory
    model, engine, cost model, disambiguator and scheduler from it, runs the
    port to completion, drains + invariant-checks the engine, and leaves
    ``engine`` / ``far`` / ``scheduler`` / ``instance`` on the session for
    inspection (traces, SPM bytes, far-memory contents).
    """

    def __init__(self, config: AmuConfig = AmuConfig(),
                 registry: WorkloadRegistry = REGISTRY):
        self.config = config
        self.registry = registry
        self.engine = None
        self.far: Optional[FarMemoryModel] = None
        self.scheduler = None
        self.instance: Optional[Port] = None
        self.sanitizer = None
        self._use_vector = False

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "AmuSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        """Drop the execution stack (runs already drain + check the engine;
        closing only releases the references)."""
        self.engine = self.far = self.scheduler = self.instance = None
        self.sanitizer = None

    # ----------------------------------------------------------------- run
    def _build(self, port: Union[str, Port], **build_kw) -> Port:
        if not isinstance(port, str):
            return port
        cfg = self.config
        return self.registry.build(port, cfg.seed, vector=cfg.vector,
                                   llvm_mode=cfg.llvm_mode,
                                   pipeline_k=cfg.pipeline_k, **build_kw)

    def prepare(self, port: Union[str, Port], *,
                record_trace: bool = False, **build_kw) -> Port:
        """Build the execution stack for `port` without running it: far
        memory, engine, disambiguator, scheduler — all from the config.
        Callers that time the run (benchmarks) call this first, then
        :meth:`execute`; :meth:`run` is the two fused."""
        cfg = self.config
        inst = self._build(port, **build_kw)
        # which port actually runs: registry builds are stamped; raw
        # prebuilt ports without the stamp fall back to the config's intent
        self._use_vector = bool(getattr(inst, "vector", cfg.vector))
        ecfg = cfg.resolve_engine_config(inst.engine_config)
        far = FarMemoryModel(
            cfg.resolve_far_config(), host_jit=cfg.host_jit,
            timeout_cycles=cfg.retry.timeout_cycles if cfg.retry else 0.0)
        eng = make_engine(cfg.engine, ecfg, far, inst.mem,
                          record_trace=record_trace)
        disamb = CuckooAddressSet() if inst.disambiguation else None
        sched = SCHEDULER_KINDS[cfg.scheduler_kind](
            eng, cost=cfg.cost_model(), disambiguator=disamb,
            dma_mode=cfg.dma_mode, retry=cfg.retry)
        eng.port_name = getattr(inst, "name", "")
        self.sanitizer = None
        if cfg.sanitize:
            from repro_torch.analysis.sanitizer import AmiSanitizer
            self.sanitizer = AmiSanitizer(port=eng.port_name)
            self.sanitizer.attach(eng, sched)
        self.engine, self.far, self.scheduler, self.instance = \
            eng, far, sched, inst
        return inst

    def execute(self) -> RunStats:
        """Run the :meth:`prepare`-d port to completion, drain the engine,
        check ID-conservation invariants, and return the stats."""
        cfg = self.config
        inst, eng, sched = self.instance, self.engine, self.scheduler
        if inst is None:
            raise RuntimeError("no port prepared; call prepare() first")
        entries0, rows0 = eng.host_entries, eng.host_rows
        wall0 = time.perf_counter()
        if hasattr(inst, "make_round_tasks"):        # frontier parallelism
            frontier = [inst.root]                   # type: ignore[union-attr]
            while frontier:
                sched.run(inst.make_round_tasks(frontier))  # type: ignore
                frontier = sorted(inst.next_frontier)       # type: ignore
        else:
            sched.run(inst.tasks)
        wall_us = (time.perf_counter() - wall0) * 1e6
        entries = eng.host_entries - entries0
        rows = eng.host_rows - rows0
        eng.drain()
        eng.check_invariants()
        if self.sanitizer is not None:
            self.sanitizer.finish()      # leaked-token / held-lock report
        stats = sched.summary()
        return _stats_from_summary(
            stats, cfg, inst, eng, self._use_vector,
            self.far.region_stats(stats["cycles"]), entries, rows, wall_us)

    def run(self, port: Union[str, Port], *,
            record_trace: bool = False, **build_kw) -> RunStats:
        """Run `port` (a registered name, or a prebuilt Port) to completion.

        ``build_kw`` reaches the builder for name lookups (sizes and other
        workload knobs); ``record_trace=True`` keeps the engine's
        issue/fin trace for differential comparisons.
        """
        self.prepare(port, record_trace=record_trace, **build_kw)
        return self.execute()


# ========================================================================
# Rack-scale sessions: N cores, one shared far memory
# ========================================================================
def _core_seeds(seed: int, cores: int) -> List[int]:
    """Per-core build seeds: core 0 keeps the config seed verbatim (the
    ``cores=1`` bit-identity guarantee) and core i > 0 gets an
    independently spawned child of ``SeedSequence(seed)`` — statistically
    independent streams, deterministic per (seed, cores)."""
    if cores == 1:
        return [seed]
    children = np.random.SeedSequence(seed).spawn(cores - 1)
    return [seed] + [int(c.generate_state(1, np.uint64)[0])
                     for c in children]


def _jain_fairness(xs: Sequence[float]) -> float:
    """Jain's fairness index (Σx)² / (N·Σx²) ∈ (0, 1]; 1.0 = all equal."""
    sq = sum(x * x for x in xs)
    if sq <= 0.0:
        return 1.0
    s = sum(xs)
    return (s * s) / (len(xs) * sq)


@dataclass(frozen=True)
class RackStats:
    """Result of one :meth:`RackSession.run`: the per-core dimension plus
    rack-level aggregates.

    ``cores`` holds one :class:`RunStats` per core. With ``cores=1`` the
    single entry is bit-identical to the plain :class:`AmuSession` result;
    with N > 1 each core's ``requests``/``bytes``/fault counters are the
    arbiter-attributed share of the shared device's global counters, its
    ``mlp`` is 0.0 (in-flight overlap on a shared device has no exact
    per-core split — ``RackStats.mlp`` carries the true device MLP), and
    ``regions`` is ``None`` (the shared per-tier split lives on
    ``RackStats.regions``).

    ``core_gups`` is per-core throughput in giga-units/sec (logical work
    units per nanosecond — true GUPS when the port is GUPS);
    ``aggregate_gups`` divides total units by the rack **makespan** (the
    slowest core), so it only scales with cores while the shared links
    have headroom. ``fairness`` is Jain's index over ``core_gups`` and
    ``link_occupancy`` maps each far-memory link to its serialized-cycle
    total, busy fraction of the makespan, and per-core split.
    """
    cores: Tuple[RunStats, ...]
    cycles: float                       # makespan, cycles
    us: float
    requests: int
    bytes: int
    mlp: float                          # shared-device MLP over the makespan
    core_gups: Tuple[float, ...]
    aggregate_gups: float
    fairness: float
    link_occupancy: Dict[str, Dict[str, object]]
    regions: Optional[Dict[str, Dict[str, float]]]
    verified: Optional[bool]

    @property
    def n_cores(self) -> int:
        return len(self.cores)


class RackSession:
    """Context manager owning a rack of AMU execution stacks.

    ``run(ports)`` builds N per-core engine+SPM+scheduler stacks over ONE
    shared far-memory model and drives them through the deterministic
    global-clock arbiter (:class:`repro_torch.core.rack.RackArbiter` — ties
    break by core index). ``ports`` is a single registered name / prebuilt
    port (homogeneous rack: every core runs it, core i built with its own
    spawned seed) or a sequence of ``config.cores`` of them (colocation
    scenarios, e.g. GUPS next to ``paged_kv_serve``). Frontier-parallel
    ports (BFS) need a per-level outer driver and are not rack-schedulable.

    After the run each engine is drained and invariant-checked; the
    per-core stacks stay inspectable on ``engines`` / ``schedulers`` /
    ``instances`` (and the shared model on ``far``).
    """

    def __init__(self, config: AmuConfig = AmuConfig(),
                 registry: WorkloadRegistry = REGISTRY):
        self.config = config
        self.registry = registry
        self.far: Optional[FarMemoryModel] = None
        self.engines: List = []
        self.schedulers: List = []
        self.instances: List[Port] = []
        self.sanitizers: List = []
        self._use_vector: List[bool] = []

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "RackSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        self.far = None
        self.engines, self.schedulers, self.instances = [], [], []
        self._use_vector = []

    # ----------------------------------------------------------------- run
    def prepare(self, ports: Union[str, Port, Sequence], *,
                record_trace: bool = False, **build_kw) -> List[Port]:
        """Build all per-core stacks without running them: one shared far
        model, then per core a workload instance (spawned seed), engine,
        disambiguator and scheduler."""
        cfg = self.config
        n = cfg.cores
        if isinstance(ports, str) or not isinstance(ports, Sequence):
            if n > 1 and not isinstance(ports, str):
                # one prebuilt instance can't back N cores: its tasks and
                # memory image are single-use state
                raise ValueError(
                    "a homogeneous rack takes a registered workload NAME "
                    "(each core rebuilds with its own spawned seed); for "
                    "prebuilt ports pass one per core")
            port_list = [ports] * n
        else:
            port_list = list(ports)
            if len(port_list) != n:
                raise ValueError(
                    f"got {len(port_list)} ports for cores={n}; pass one "
                    f"port (homogeneous rack) or exactly one per core")
        seeds = _core_seeds(cfg.seed, n)
        far = FarMemoryModel(
            cfg.resolve_far_config(), host_jit=cfg.host_jit,
            timeout_cycles=cfg.retry.timeout_cycles if cfg.retry else 0.0)
        self.far = far
        self.engines, self.schedulers, self.instances = [], [], []
        self.sanitizers = []
        self._use_vector = []
        for i, port in enumerate(port_list):
            if isinstance(port, str):
                inst = self.registry.build(
                    port, seeds[i], vector=cfg.vector,
                    llvm_mode=cfg.llvm_mode, pipeline_k=cfg.pipeline_k,
                    **build_kw)
            else:
                inst = port
            if hasattr(inst, "make_round_tasks"):
                raise NotImplementedError(
                    f"frontier-parallel port {inst.name!r} needs a "
                    f"per-level outer driver; not rack-schedulable")
            self._use_vector.append(bool(getattr(inst, "vector",
                                                 cfg.vector)))
            ecfg = cfg.resolve_engine_config(inst.engine_config)
            eng = make_engine(cfg.engine, ecfg, far, inst.mem,
                              record_trace=record_trace, label=f"core{i}")
            disamb = CuckooAddressSet() if inst.disambiguation else None
            sched = SCHEDULER_KINDS[cfg.scheduler_kind](
                eng, cost=cfg.cost_model(), disambiguator=disamb,
                dma_mode=cfg.dma_mode, retry=cfg.retry)
            eng.port_name = getattr(inst, "name", "")
            if cfg.sanitize:
                from repro_torch.analysis.sanitizer import AmiSanitizer
                san = AmiSanitizer(port=eng.port_name, label=f"core{i}")
                san.attach(eng, sched)
                self.sanitizers.append(san)
            self.engines.append(eng)
            self.schedulers.append(sched)
            self.instances.append(inst)
        return self.instances

    def execute(self) -> RackStats:
        """Arbitrate the :meth:`prepare`-d cores to completion, drain and
        invariant-check every engine, and return the rack stats."""
        cfg = self.config
        if not self.instances:
            raise RuntimeError("no ports prepared; call prepare() first")
        n = len(self.instances)
        arb = RackArbiter(self.far, self.schedulers)
        for sched, inst in zip(self.schedulers, self.instances):
            for task in inst.tasks:
                sched.spawn(task)
        arb.run()
        per_core: List[RunStats] = []
        for i in range(n):
            eng, sched, inst = self.engines[i], self.schedulers[i], \
                self.instances[i]
            eng.drain()
            eng.check_invariants()
            if self.sanitizers:
                self.sanitizers[i].finish()
            stats = dict(sched.summary())
            if n == 1:
                regions = self.far.region_stats(stats["cycles"])
            else:
                # shared-device counters: replace the global reads with
                # the arbiter's per-core attribution (regions/MLP stay
                # rack-level — see RackStats)
                regions = None
                stats["requests"] = arb.requests[i]
                stats["bytes"] = arb.bytes_moved[i]
                stats["mlp"] = 0.0
                if "faults_injected" in stats:
                    stats["faults_injected"] = arb.errors[i] \
                        + arb.timeouts[i]
                    stats["timeouts"] = arb.timeouts[i]
                    logical = (arb.requests[i] - stats["retries"]
                               - stats["failovers"])
                    stats["availability"] = \
                        1.0 - stats["failed"] / max(logical, 1)
            per_core.append(_stats_from_summary(
                stats, cfg, inst, eng, self._use_vector[i], regions,
                eng.host_entries, eng.host_rows, arb.wall_us[i]))
        makespan = arb.makespan
        us = makespan / (FREQ_GHZ * 1e3)
        core_gups = tuple(
            (s.units / s.us) * 1e-3 if s.us > 0 else 0.0 for s in per_core)
        total_units = sum(s.units for s in per_core)
        verified: Optional[bool] = None
        if cfg.verify:
            verified = all(bool(s.verified) for s in per_core)
        return RackStats(
            cores=tuple(per_core),
            cycles=makespan,
            us=us,
            requests=self.far.requests,
            bytes=self.far.bytes_moved,
            mlp=self.far.avg_mlp(makespan),
            core_gups=core_gups,
            aggregate_gups=(total_units / us) * 1e-3 if us > 0 else 0.0,
            fairness=_jain_fairness(core_gups),
            link_occupancy=self.far.link_occupancy(makespan),
            regions=self.far.region_stats(makespan),
            verified=verified)

    def run(self, ports: Union[str, Port, Sequence], *,
            record_trace: bool = False, **build_kw) -> RackStats:
        """Run `ports` across the rack to completion (prepare + execute)."""
        self.prepare(ports, record_trace=record_trace, **build_kw)
        return self.execute()
