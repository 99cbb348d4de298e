"""Add a new AMU workload: the `@workload` + `ctx` + session pattern end to
end, on the port's own copy of the simulator.

The counterpart of `examples/amu_workload.py`, with its workload and its
output. "DOTV" computes a dot product over two far-memory vectors: each
coroutine vector-loads a chunk of both operands per generator hop
(`ctx.aload_vec`), reduces through zero-copy `ctx.spm_read` views,
publishes its partial far-side with `ctx.astore`, and the workload's
`verify()` pins the stored partials against numpy. `register` puts it in
`repro_torch.amu.REGISTRY` (the reference's example does that at import;
here `main` does, so that importing this module changes no registry), and
`main` runs it under three `AmuConfig`s. The figures are the model's
(modelled microseconds and MLP), the same on every machine.

    PYTHONPATH=src python -m repro_torch.launch.amu_workload
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.amu import REGISTRY, AmuConfig, AmuSession, ctx, workload
from repro_torch.configs.base import EngineConfig
from repro_torch.core.workloads import WorkloadInstance

CHUNK = 16              # 8B words fetched per vector command, per operand


def build_dotv(seed: int = 0, n: int = 4096,
               coroutines: int = 8) -> WorkloadInstance:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 20, size=n).astype(np.float64)
    b = rng.integers(0, 1 << 20, size=n).astype(np.float64)
    mem = np.concatenate([a, b, np.zeros(coroutines)]).view(np.uint8).copy()
    b_off, sum_off = n * 8, 2 * n * 8                # partials live far-side

    def task(c: int, lo: int, hi: int):
        sa = c * 2 * CHUNK * 8                       # a-slots | b-slots
        sb = sa + CHUNK * 8
        acc = 0.0
        for k0 in range(lo, hi, CHUNK):
            cnt = min(CHUNK, hi - k0)
            offs = np.arange(k0, k0 + cnt) * 8
            slots = np.arange(cnt) * 8
            yield ctx.aload_vec(np.concatenate([sa + slots, sb + slots]),
                                np.concatenate([offs, b_off + offs]), 8)
            va = yield ctx.spm_read(sa, cnt * 8)     # zero-copy views
            vb = yield ctx.spm_read(sb, cnt * 8)
            acc += float(va.view(np.float64) @ vb.view(np.float64))
            yield ctx.cost(insts=2 * cnt)
        yield ctx.spm_write(sa, np.float64(acc).tobytes())
        yield ctx.astore(sa, sum_off + c * 8, 8)     # publish the partial

    bounds = np.linspace(0, n, coroutines + 1).astype(int)
    tasks = [task(c, bounds[c], bounds[c + 1]) for c in range(coroutines)]

    def verify(mem_out: np.ndarray) -> bool:
        parts = mem_out[sum_off:sum_off + coroutines * 8].view(np.float64)
        return bool(np.isclose(parts.sum(), float(a @ b)))

    return WorkloadInstance("DOTV", mem, tasks, n,
                            EngineConfig(queue_length=512, granularity=8),
                            verify)


def register() -> None:
    """Registers DOTV in the port's registry, once."""
    if "DOTV" not in REGISTRY:
        workload("DOTV", description="far-memory dot product, "
                 "vector-loaded chunks")(build_dotv)


def main(argv: Optional[List[str]] = None) -> List[Dict[str, object]]:
    """Runs DOTV under the three configurations; a row each: `label`, `us`,
    `mlp`, `requests`, `verified`. An unverified run raises."""
    del argv                                         # no flags
    register()
    print("DOTV through AmuSession (same port, three configurations):")
    base = AmuConfig(engine="batched", latency_us=1.0)
    rows = []
    for label, cfg in [("batched @1us", base),
                       ("scalar oracle @1us", base.derive(engine="scalar")),
                       ("batched @5us", base.derive(latency_us=5.0))]:
        with AmuSession(cfg) as s:
            st = s.run("DOTV")
            if not st.verified:
                raise AssertionError("dot product wrong!")
            print(f"  {label:>20s}: {st.us:8.1f}us  mlp={st.mlp:5.1f}  "
                  f"requests={st.requests}")
        rows.append({"label": label, "us": st.us, "mlp": st.mlp,
                     "requests": st.requests, "verified": st.verified})
    print("ok: verified under every configuration")
    return rows


if __name__ == "__main__":
    main()
