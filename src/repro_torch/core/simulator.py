"""Cycle-approximate performance model of the paper's four configurations.

The paper evaluates on Gem5 (Table 2: 3 GHz 6-wide OoO, 512 ROB, 192 LSQ,
48 MSHRs). We reproduce the *performance claims* with a two-part model:

* **Baseline / CXL-Ideal(+BOP)** — an out-of-order *window model*
  (`simulate_window`): iterations of a workload's
  :class:`~repro_torch.core.workloads.IterationProfile` flow through a reorder
  window. An iteration may begin issuing only when the iteration
  `window_iters` back has retired (ROB occupancy), far loads contend for
  MSHRs (modeled as the far-memory channel's `max_inflight`), stores drain
  through a finite store buffer, and dependent (chase) loads serialize.
  CXL-Ideal raises MSHRs to 256 everywhere and adds a best-offset prefetcher
  that covers a fraction of loads for `sequential=True` workloads.

* **AMU / AMU (DMA-mode)** — not a model at all: the *actual* coroutine
  ports of the benchmarks execute against the timed engine through a
  :class:`repro_torch.amu.AmuSession`. Execution time, IPC, and MLP fall out of
  the run. DMA-mode sets `batch_ids=1` and the per-request
  descriptor/doorbell cost, reproducing the external-engine ablation. The
  session's :class:`repro_torch.amu.AmuConfig` picks the scalar per-event oracle
  (:class:`~repro_torch.core.engine.AsyncMemoryEngine`) or the vectorized batched
  path (:class:`~repro_torch.core.engine.BatchedAsyncMemoryEngine` +
  :class:`~repro_torch.core.coroutines.BatchScheduler`), which are proven
  trace-equivalent by tests/test_batched_engine.py.

Calibration: the free constants (instruction counts per iteration, coroutine
switch cost, store-buffer depth) were tuned once against the paper's headline
numbers (geo-mean 2.42x @1us; GUPS 26.86x @5us with >130 MLP) and then frozen;
EXPERIMENTS.md reports the residuals.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.amu import REGISTRY, AmuConfig, AmuSession
from repro_torch.amu.config import FREQ_GHZ, LINE, far_config
from repro_torch.core.farmem import FarMemoryModel
from repro_torch.core.workloads import IterationProfile  # noqa: F401 (re-export +
#                                                    registry population)


@dataclass(frozen=True)
class CoreConfig:
    """Gem5 baseline configuration (Table 2)."""
    issue_width: int = 6
    rob: int = 512
    lsq: int = 192
    mshr: int = 48
    store_buffer: int = 56
    l2_hit_cycles: float = 10.0
    local_dram_cycles: float = 240.0     # ~80 ns local DRAM
    pf_coverage: float = 0.0             # BOP prefetch coverage (CXL-Ideal)
    pf_mshr_share: float = 0.5           # prefetches consume MSHR bandwidth


BASELINE_CORE = CoreConfig()
CXL_IDEAL_CORE = CoreConfig(mshr=256, pf_coverage=0.8)


# =========================================================================
# Baseline OoO window model
# =========================================================================
def simulate_window(profile: IterationProfile, iters: int, latency_us: float,
                    core: CoreConfig = BASELINE_CORE,
                    seed: int = 0) -> Dict[str, float]:
    """Window model of a synchronous load/store loop.

    Iterations overlap up to the reorder-window depth (ROB/LSQ-bounded);
    within an iteration, chase loads serialize and independent loads overlap.
    Individual completions are order-independent (t + latency); global
    resource limits are applied as Little's-law lower bounds on total time:
    sustained far-op concurrency <= `mlp_cap` (or the window-derived limit,
    capped by MSHRs) and link bandwidth over total bytes.
    """
    rng = np.random.default_rng(seed)
    cfg = far_config(latency_us)
    lat = cfg.base_latency_cycles
    serial = LINE / cfg.bandwidth_bytes_per_cycle

    mem_ops = profile.chase + profile.indep_loads + profile.stores
    iter_insts = profile.insts + 2 * mem_ops       # addr-gen + the op itself

    if profile.mlp_cap:
        # Additive Little's-law mode (fitted against Table 4): serialized
        # core/local work plus far-memory occupancy at the effective
        # concurrency cap. CXL-Ideal's extra MSHRs scale the cap; its BOP
        # prefetcher covers sequential loads (they become near-L2 hits but
        # still traverse the link -> bandwidth term).
        cap = profile.mlp_cap * (core.mshr / BASELINE_CORE.mshr)
        cap = min(cap, core.mshr)
        loads = (profile.chase + profile.indep_loads) * iters
        covered = 0.0
        if profile.sequential and core.pf_coverage:
            covered = loads * core.pf_coverage
        far_loads = (loads - covered) * (1.0 - profile.local_frac)
        far_ops_f = far_loads + profile.stores * iters
        far_bytes_f = (far_loads + covered * (1.0 - profile.local_frac)
                       + profile.stores * iters) * LINE
        core_total = iters * (iter_insts / core.issue_width
                              + profile.local_cycles)
        total = core_total + far_ops_f * lat / cap
        total = max(total, far_bytes_f / cfg.bandwidth_bytes_per_cycle)
        insts = iters * iter_insts
        return {
            "cycles": total,
            "insts": insts,
            "ipc": insts / max(total, 1e-9),
            "mlp": far_ops_f * lat / max(total, 1e-9),
            "requests": int(far_ops_f),
            "bytes": int(far_bytes_f),
            "disamb_frac": 0.0,
        }

    window = max(1, min(int(core.rob // max(iter_insts, 1)),
                        int(core.lsq // max(mem_ops, 1e-9))))

    done: List[float] = []           # retire time per iteration
    store_done: List[float] = []     # completion times of issued stores
    core_t = 0.0
    issue_cycles = iter_insts / core.issue_width
    n_stores_frac = 0.0
    far_ops = 0
    far_bytes = 0

    def load_latency(t: float) -> float:
        """One demand load issued at t; returns its completion time."""
        nonlocal far_ops, far_bytes
        if profile.local_frac and rng.random() < profile.local_frac:
            return t + core.l2_hit_cycles
        if (profile.sequential and core.pf_coverage
                and rng.random() < core.pf_coverage):
            # covered by the L2 best-offset prefetcher: near-L2 hit; the
            # prefetch still moved the line over the link (bandwidth bound)
            far_bytes += LINE
            return t + core.l2_hit_cycles
        far_ops += 1
        far_bytes += LINE
        return t + serial + lat

    for i in range(iters):
        start = core_t
        if i >= window:
            start = max(start, done[i - window])   # ROB head must retire
        # store buffer back-pressure: the (i - SB)'th store must have drained
        if len(store_done) > core.store_buffer:
            start = max(start, store_done[len(store_done)
                                          - core.store_buffer - 1])
        core_t = start + issue_cycles + profile.local_cycles
        t = start + issue_cycles * 0.5 + profile.local_cycles
        chase_t = t
        for _ in range(int(profile.chase)):
            chase_t = load_latency(chase_t)
        indep_t = t
        for _ in range(int(profile.indep_loads)):
            indep_t = max(indep_t, load_latency(t))
        iter_done = max(chase_t, indep_t, core_t)
        n_stores_frac += profile.stores
        while n_stores_frac >= 1.0:
            far_ops += 1
            far_bytes += LINE
            store_done.append(iter_done + serial + lat)
            n_stores_frac -= 1.0
        done.append(iter_done)

    total = max(done[-1], store_done[-1] if store_done else 0.0)
    # Little's-law resource bounds
    mlp_cap = profile.mlp_cap or min(window * max(mem_ops, 1), core.mshr)
    total = max(total,
                far_ops * lat / max(mlp_cap, 1e-9),         # sustained MLP
                far_bytes / cfg.bandwidth_bytes_per_cycle)  # link bandwidth
    insts = iters * iter_insts
    return {
        "cycles": total,
        "insts": insts,
        "ipc": insts / max(total, 1e-9),
        "mlp": far_ops * lat / max(total, 1e-9),
        "requests": far_ops,
        "bytes": far_bytes,
        "disamb_frac": 0.0,
    }


# =========================================================================
# Software (group) prefetching model — Table 4's PF columns
# =========================================================================
def simulate_group_prefetch(profile: IterationProfile, iters: int,
                            latency_us: float, group: int,
                            core: CoreConfig = BASELINE_CORE,
                            seed: int = 0) -> Dict[str, float]:
    """Group prefetching [16]: issue `group` prefetches, then execute the
    group's iterations. Prefetches are asynchronous but (a) consume MSHRs,
    (b) have no completion notification — the demand access stalls if the
    prefetch hasn't landed (late prefetch), and re-fetches if it was evicted
    (early prefetch, pressure-dependent)."""
    rng = np.random.default_rng(seed)
    chan = FarMemoryModel(far_config(latency_us, max_inflight=core.mshr))
    loads_per_iter = profile.chase + profile.indep_loads
    iter_insts = profile.insts + 2 * (loads_per_iter + profile.stores) + 2
    t = 0.0
    insts = 0.0
    # eviction probability grows once the group overflows cache/MSHR capacity
    evict_p = max(0.0, min(0.9, (group - core.mshr) / max(group, 1)))
    for g0 in range(0, iters, group):
        g = min(group, iters - g0)
        ready = []
        for k in range(g):
            t += 1.0 / core.issue_width          # prefetch instruction
            insts += 1
            ready.append(chan.issue(t, LINE * loads_per_iter))
        for k in range(g):
            t += iter_insts / core.issue_width
            insts += iter_insts
            if rng.random() < evict_p:
                t = chan.issue(t, LINE)          # re-fetch on eviction
            else:
                t = max(t, ready[k])             # late prefetch stall
            if profile.stores:
                chan.issue(t, LINE)
    return {"cycles": t, "insts": insts, "ipc": insts / max(t, 1e-9),
            "mlp": chan.avg_mlp(t), "requests": chan.requests,
            "bytes": chan.bytes_moved, "disamb_frac": 0.0}


# =========================================================================
# Top-level: one call per (workload, config, latency)
# =========================================================================
CONFIG_NAMES = ("baseline", "cxl-ideal", "amu", "amu-dma")


def run(workload: str, config: str, latency_us: float,
        seed: int = 0, amu: Optional[AmuConfig] = None,
        **kw) -> Dict[str, float]:
    """One (workload, config, latency) data point.

    ``baseline``/``cxl-ideal`` drive the OoO window model; the ``amu*``
    configs run the real coroutine port through an :class:`AmuSession`.
    `amu` is the base :class:`AmuConfig` for those runs (defaults to the
    scalar per-event oracle); remaining ``kw`` are derived onto it
    (``engine=``, ``vector=``, ``verify=``, ``engine_config=``, ...), so
    existing keyword call sites keep working unchanged.
    """
    wd = REGISTRY[workload]
    if config == "baseline":
        inst_units = wd.build(seed).units
        out = simulate_window(wd.profile, inst_units, latency_us,
                              BASELINE_CORE, seed=seed)
    elif config == "cxl-ideal":
        inst_units = wd.build(seed).units
        out = simulate_window(wd.profile, inst_units, latency_us,
                              CXL_IDEAL_CORE, seed=seed)
    elif config in ("amu", "amu-dma", "amu-llvm"):
        cfg = (amu or AmuConfig(engine="scalar")).derive(
            latency_us=latency_us, seed=seed,
            dma_mode=config == "amu-dma",
            llvm_mode=config == "amu-llvm", **kw)
        with AmuSession(cfg) as session:
            out = session.run(workload).to_dict()
    else:
        raise KeyError(config)
    out["config"] = config
    out["workload"] = workload
    out["latency_us"] = latency_us
    out["us"] = out["cycles"] / (FREQ_GHZ * 1e3)
    return out


# ------------------------------------------------------------- power model
@dataclass(frozen=True)
class PowerModel:
    """McPAT-style first-order energy accounting (Fig 11)."""
    static_w: float = 1.2           # core + L2 leakage
    epi_nj: float = 0.35            # energy per retired instruction
    epr_nj: float = 2.0             # energy per far-memory request (I/O)
    spm_nj: float = 0.15            # per SPM touch (AMU metadata upkeep)

    def power(self, stats: Dict[str, float], spm_touches: float = 0.0) -> float:
        t_s = stats["cycles"] / (FREQ_GHZ * 1e9)
        dyn = (stats["insts"] * self.epi_nj + stats["requests"] * self.epr_nj
               + spm_touches * self.spm_nj) * 1e-9
        return self.static_w + dyn / max(t_s, 1e-12)
