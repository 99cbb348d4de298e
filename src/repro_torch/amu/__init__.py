"""Unified AMU session API — the paper's programming framework as one
coherent public surface.

Three pieces (see TESTING.md for the migration table from the old knobs):

* :class:`AmuConfig` — one frozen config object (engine kind, scheduler
  kind, vector/pipeline-K, DMA mode, SPM budget, far-memory operating
  point) with validation and ``derive``-style variation.
* :class:`AmuSession` — a context manager owning engine + scheduler +
  far-memory lifecycle; ``session.run(port) -> RunStats``.
  :class:`RackSession` is its rack-scale sibling: ``AmuConfig(cores=N)``
  runs N per-core stacks over one shared far memory
  (``run(ports) -> RackStats``).
* :func:`workload` / :data:`REGISTRY` — the pluggable workload registry
  (one decorated builder per scenario, with declared capabilities), plus
  the :class:`Port` protocol any custom workload can satisfy.

Port bodies use the typed command facade :data:`ctx`
(``yield ctx.aload(...)`` etc.) instead of hand-rolling command objects.

The port's own copy of the reference's `repro.amu`: numpy and the standard
library only, the same logic line for line, so the scalar and batched
engines, the schedulers and the workloads give the same traces and stats in
both packages; `tests/test_torch_sim_*.py` hold the two copies equal, and a
change to one lands in the other.
"""
from repro_torch.amu.commands import CommandFacade, ctx
from repro_torch.analysis.sanitizer import AmiProtocolError
from repro_torch.amu.config import (FREQ_GHZ, LINE, AmuConfig, RetryPolicy,
                                    far_config, far_region)
from repro_torch.amu.registry import (REGISTRY, Port, WorkloadDef,
                                      WorkloadRegistry, workload)
from repro_torch.amu.session import AmuSession, RackSession, RackStats, RunStats
from repro_torch.core.farmem import (STATUS_ERROR, STATUS_OK, STATUS_TIMED_OUT,
                                     BimodalTail, FarMemoryConfig, FarMemoryRegion,
                                     FaultModel, LatencyDistribution, LinkFlap,
                                     LognormalLatency, UniformJitter)

# Populate REGISTRY with the built-in Table 3 workloads. Deliberately last:
# the port module imports the facade/registry submodules above, which are
# fully initialized by now even when the import chain started from
# `repro_torch.core.workloads` itself.
import repro_torch.core.workloads  # noqa: E402,F401  (registration side-effect)
import repro_torch.core.serving    # noqa: E402,F401  (registers paged_kv_serve)

__all__ = [
    "AmuConfig", "AmuSession", "RunStats", "RackSession", "RackStats",
    "ctx", "CommandFacade",
    "workload", "Port", "WorkloadDef", "WorkloadRegistry", "REGISTRY",
    "far_config", "far_region", "FREQ_GHZ", "LINE",
    "FarMemoryConfig", "FarMemoryRegion", "LatencyDistribution",
    "UniformJitter", "LognormalLatency", "BimodalTail",
    "FaultModel", "LinkFlap", "RetryPolicy",
    "STATUS_OK", "STATUS_ERROR", "STATUS_TIMED_OUT",
    "AmiProtocolError",
]
