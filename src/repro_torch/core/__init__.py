"""The paper's contribution: AMI semantics, AMU engine, coroutine framework,
software memory disambiguation, and the calibrated performance model.

The public programming surface (config + session + registry + command
facade) lives in :mod:`repro_torch.amu`; this package holds the mechanism.

The port's own copy of the reference's `repro.core`: numpy and the standard
library only, the same logic line for line, so the scalar and batched
engines, the schedulers and the workloads give the same traces and stats in
both packages; `tests/test_torch_sim_*.py` hold the two copies equal, and a
change to one lands in the other."""
from repro_torch.core.coroutines import (Acquire, AcquireVec, Aload, AloadNoWait,
                                         AloadVec, Astore, AstoreNoWait, AstoreVec,
                                         AwaitRid, AwaitRids, BatchScheduler, Cost,
                                         CostModel, Release, ReleaseVec, Scheduler,
                                         SpmRead, SpmWrite)
from repro_torch.core.disambiguation import CuckooAddressSet
from repro_torch.core.engine import (AsyncMemoryEngine, BatchedAsyncMemoryEngine,
                                     make_engine)
from repro_torch.core.farmem import (BimodalTail, FarMemoryConfig, FarMemoryModel,
                                     FarMemoryRegion, InstantMemory,
                                     LatencyDistribution, LognormalLatency,
                                     UniformJitter)
