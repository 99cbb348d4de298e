"""`AmuConfig` — one frozen, validated config object for an AMU run.

Replaces the six orthogonal knobs that used to thread positionally through
``run_amu`` / ``sim.run`` / the builders (``engine=``, ``vector=``,
``dma_mode=``, pipeline ``K``, SPM budget, far-memory latency): construct
one config, derive variants with :meth:`AmuConfig.derive`, hand it to
:class:`repro_torch.amu.AmuSession`.

Migration table (old knob -> config field) lives in TESTING.md.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, replace
from typing import Optional, Sequence, Union

from repro_torch.configs.base import EngineConfig
from repro_torch.core.coroutines import SCHEDULER_KINDS, CostModel
from repro_torch.core.engine import ENGINE_KINDS
from repro_torch.core.farmem import (FarMemoryConfig, FarMemoryRegion, FaultModel,
                                     LatencyDistribution)

#: Simulated core clock (Table 2: 3 GHz, 6-wide OoO).
FREQ_GHZ = 3.0
#: Baseline cache-line granularity.
LINE = 64


def _env_sanitize() -> bool:
    """Default for ``AmuConfig.sanitize``: the ``AMU_SANITIZE`` env var,
    so CI can run an entire suite with the sanitizer attached without
    threading the flag through every constructor."""
    return os.environ.get("AMU_SANITIZE", "").lower() not in ("", "0", "false")


def far_config(latency_us: float, bandwidth_gbs: float = 64.0,
               max_inflight: int = 0, **kw) -> FarMemoryConfig:
    """The paper's far-memory operating point at `latency_us` (Fig 1/7).
    Extra keywords reach :class:`FarMemoryConfig` (e.g. ``distribution=``
    for a tail-latency draw). (Transfer granularity is a property of each
    request, not of the device — set it on the :class:`EngineConfig`
    instead.)"""
    return FarMemoryConfig.from_latency_us(
        latency_us, freq_ghz=FREQ_GHZ, bandwidth_gbs=bandwidth_gbs,
        max_inflight=max_inflight, **kw)


def far_region(name: str, start: int, size: int, latency_us: float,
               bandwidth_gbs: float = 64.0, max_inflight: int = 0,
               link: Optional[str] = None,
               distribution: Optional[LatencyDistribution] = None,
               jitter_frac: float = 0.0,
               faults: Optional[FaultModel] = None,
               failover: Optional[str] = None) -> FarMemoryRegion:
    """One tier of a heterogeneous far memory, in the paper's µs / GB/s
    units. Pass a list of these as ``AmuConfig(far=[...])`` to run a
    workload against mixed local-DRAM / fast-CXL / cross-switch tiers;
    regions naming the same ``link`` contend on one shared channel.
    ``faults`` attaches a seeded :class:`FaultModel` (error/drop draws,
    outage windows); ``failover`` names the region that absorbs this one's
    requests after retry exhaustion."""
    return FarMemoryRegion.from_latency_us(
        name, start, size, latency_us, freq_ghz=FREQ_GHZ,
        bandwidth_gbs=bandwidth_gbs, max_inflight=max_inflight, link=link,
        distribution=distribution, jitter_frac=jitter_frac,
        faults=faults, failover=failover)


@dataclass(frozen=True)
class RetryPolicy:
    """Recovery policy for faulted far-memory requests (the AMI side of
    the fault plane). A scheduler given a policy re-issues each failed or
    timed-out request up to ``max_retries`` times with deterministic
    exponential backoff (``backoff * 2**attempt`` core cycles between the
    failure notice and the re-issue); after exhaustion it tries the
    region's configured ``failover`` region once, and only then delivers
    the failure status to the awaiting coroutine. ``timeout_cycles`` > 0
    additionally classifies any request whose modeled completion exceeds
    its issue time by more than that budget as TIMED_OUT at the deadline
    (a client-side timer on top of the device-side fault draws). All
    retry traffic is charged to the far-memory ledger honestly — retries
    are real requests."""

    max_retries: int = 3
    timeout_cycles: float = 0.0
    backoff: float = 256.0

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.timeout_cycles < 0.0:
            raise ValueError(
                f"timeout_cycles must be >= 0, got {self.timeout_cycles}")
        if self.backoff < 0.0:
            raise ValueError(f"backoff must be >= 0, got {self.backoff}")


@dataclass(frozen=True)
class AmuConfig:
    """Everything an AMU execution needs, in one validated object.

    * ``engine`` — timed-engine implementation: ``"scalar"`` (the per-event
      oracle) or ``"batched"`` (vectorized SoA; production sweeps).
    * ``scheduler`` — runtime loop: ``"auto"`` (follow the engine:
      ``"fused"`` on the batched engine, ``"scalar"`` on the oracle),
      ``"scalar"`` (one getfin + one task step per turn), ``"batched"``
      (epoch-stepped ``getfin_all`` drain) or ``"fused"`` (epoch-stepped
      AND epoch-staged: one engine/far entry per epoch; bit-identical to
      ``"batched"`` on the same engine).
    * ``host_jit`` — compile the far model's sequential host loops
      (injection chains, MLP ledger accumulation) with numba when it is
      importable; silently falls back to the pure-numpy paths otherwise.
      Bit-identical either way — this is a host-throughput knob, not a
      model knob.
    * ``vector`` — run the workload's AloadVec/AstoreVec (or software-
      pipelined chase) port where one is registered.
    * ``pipeline_k`` — chases per coroutine for pipelined ports
      (``None`` -> the port's default).
    * ``dma_mode`` — external-engine ablation: ``batch_ids=1`` plus the
      per-request descriptor/doorbell cost.
    * ``llvm_mode`` — compiler-lowered loop cost model (Table 4 AMU-LLVM),
      plus any workload-declared LLVM rebuild kwargs.
    * ``latency_us`` / ``max_inflight`` — far-memory operating point
      (``max_inflight`` models device-side queue backpressure, 0 =
      unlimited); ``far`` replaces both with a fully custom
      :class:`FarMemoryConfig` *or a sequence of*
      :class:`~repro_torch.core.farmem.FarMemoryRegion` (heterogeneous tiers,
      validated and normalized into one config) — setting ``far`` together
      with a non-default latency/backpressure knob is rejected, so a
      sweep's ``derive(latency_us=...)`` can never be silently ignored.
    * ``engine_config`` — overrides the workload's sized
      :class:`EngineConfig` wholesale; ``spm_bytes`` overrides just the
      SPM budget of whichever config is in effect.
    * ``retry`` — :class:`RetryPolicy` for faulted far-memory requests
      (deterministic backoff re-issue, then failover); also arms the far
      model's client-side ``timeout_cycles`` timer. ``None`` (default)
      delivers failure statuses immediately with no retry traffic.
    * ``cores`` — rack width: N complete engine+SPM+scheduler stacks over
      ONE shared far-memory model, interleaved by the deterministic
      global-clock arbiter (``repro_torch.core.rack``). ``cores=1`` (default)
      is bit-identical to the plain single-core session; N > 1 runs go
      through :class:`repro_torch.amu.RackSession`.
    * ``seed`` / ``verify`` — build seed; run the port's numpy oracle at
      the end. In a rack, core 0 builds with ``seed`` verbatim and core
      i > 0 with a child seed spawned from ``SeedSequence(seed)``.
    * ``sanitize`` — attach the AMI protocol sanitizer
      (:class:`repro_torch.analysis.AmiSanitizer`) to every engine+scheduler
      stack of the run (each rack core gets its own): SPM shadow map for
      DMA/SPM races, rid lifecycle leak report at port exit, lock-order
      cycle detection. Pure observation — traces/stats/RNG bitstreams are
      bit-identical with it on or off; violations raise
      :class:`repro_torch.analysis.AmiProtocolError`. Defaults to the
      ``AMU_SANITIZE`` environment variable (unset/0/false -> off), so a
      whole suite can be run sanitized without touching call sites.
    """
    engine: str = "batched"
    scheduler: str = "auto"
    host_jit: bool = False
    vector: bool = False
    pipeline_k: Optional[int] = None
    dma_mode: bool = False
    llvm_mode: bool = False
    latency_us: Optional[float] = None     # None -> 1.0 (unless far= given)
    max_inflight: int = 0
    far: Optional[Union[FarMemoryConfig,
                        Sequence[FarMemoryRegion]]] = None
    engine_config: Optional[EngineConfig] = None
    spm_bytes: Optional[int] = None
    retry: Optional[RetryPolicy] = None
    cores: int = 1
    seed: int = 0
    verify: bool = True
    sanitize: bool = dataclasses.field(default_factory=lambda: _env_sanitize())

    def __post_init__(self) -> None:
        if self.engine not in ENGINE_KINDS:
            raise KeyError(f"unknown engine {self.engine!r}; "
                           f"known: {sorted(ENGINE_KINDS)}")
        if self.scheduler != "auto" and self.scheduler not in SCHEDULER_KINDS:
            raise KeyError(f"unknown scheduler {self.scheduler!r}; "
                           f"known: {sorted(SCHEDULER_KINDS)} or 'auto'")
        if self.pipeline_k is not None and self.pipeline_k < 1:
            raise ValueError(f"pipeline_k must be >= 1, got {self.pipeline_k}")
        if self.far is not None and not isinstance(self.far, FarMemoryConfig):
            # a sequence of regions: validate and normalize into one
            # FarMemoryConfig (FarMemoryConfig.__post_init__ checks range
            # ordering, name uniqueness, per-region knob sanity)
            regions = tuple(self.far)
            if not regions or not all(isinstance(r, FarMemoryRegion)
                                      for r in regions):
                raise TypeError(
                    "far= takes a FarMemoryConfig or a non-empty sequence "
                    f"of FarMemoryRegion, got {self.far!r}")
            # seed stays FarMemoryConfig's default, matching the flat
            # resolve path; a custom far-memory seed is spelled as an
            # explicit FarMemoryConfig(regions=..., seed=...)
            object.__setattr__(self, "far", FarMemoryConfig(regions=regions))
        if self.far is not None and (self.latency_us is not None
                                     or self.max_inflight):
            # an explicit FarMemoryConfig replaces the whole operating
            # point; rejecting the combination means a sweep's
            # derive(latency_us=...) can never be silently discarded
            raise ValueError(
                "far= replaces the whole far-memory model; don't also set "
                "latency_us/max_inflight (derive a new far_config instead)")
        if self.latency_us is not None and not self.latency_us > 0:
            raise ValueError(f"latency_us must be > 0, got {self.latency_us}")
        if self.max_inflight < 0:
            raise ValueError(
                f"max_inflight must be >= 0, got {self.max_inflight}")
        if self.spm_bytes is not None and self.spm_bytes <= 0:
            raise ValueError(f"spm_bytes must be > 0, got {self.spm_bytes}")
        if self.retry is not None and not isinstance(self.retry, RetryPolicy):
            raise TypeError(f"retry= takes a RetryPolicy, got {self.retry!r}")
        if not isinstance(self.cores, int) or isinstance(self.cores, bool) \
                or self.cores < 1:
            raise ValueError(f"cores must be an int >= 1, got {self.cores!r}")
        if self.seed < 0:
            raise ValueError(f"seed must be >= 0, got {self.seed}")

    # ------------------------------------------------------------ derive
    def derive(self, **changes) -> "AmuConfig":
        """``dataclasses.replace`` with re-validation: the one sanctioned
        way to vary a knob (sweeps derive per-latency configs from one
        base instead of re-threading positional arguments)."""
        return replace(self, **changes)

    # ------------------------------------------------- resolved properties
    @property
    def scheduler_kind(self) -> str:
        """The runtime loop actually used. ``"auto"`` follows the engine:
        the batched engine gets the epoch-fused loop (bit-identical to the
        per-command batched loop, one engine entry per epoch), the scalar
        oracle keeps the scalar loop."""
        if self.scheduler != "auto":
            return self.scheduler
        return "fused" if self.engine == "batched" else self.engine

    def resolve_engine_config(self, port_config: EngineConfig) -> EngineConfig:
        """The :class:`EngineConfig` for a run: explicit override, else the
        port's own sizing; then the SPM budget and DMA-mode ablation."""
        ecfg = self.engine_config or port_config
        if self.spm_bytes is not None:
            ecfg = dataclasses.replace(ecfg, spm_bytes=self.spm_bytes)
        if self.dma_mode:
            ecfg = dataclasses.replace(ecfg, batch_ids=1)
        return ecfg

    def resolve_far_config(self) -> FarMemoryConfig:
        if self.far is not None:
            return self.far
        lat = 1.0 if self.latency_us is None else self.latency_us
        return far_config(lat, max_inflight=self.max_inflight)

    def cost_model(self) -> CostModel:
        if not self.llvm_mode:
            return CostModel()
        # compiler-lowered loop: no coroutine frame save/restore, fewer
        # framework instructions per op (Table 4: AMU-LLVM beats hand-ported)
        return replace(CostModel(), switch_insts=20, switch_stall_cycles=55.0,
                       ami_issue_insts=6, getfin_insts=6)
