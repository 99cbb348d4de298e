"""Per-device roofline counts of an eager PyTorch step, op by op.

The counterpart of `src/repro/launch/hlo_analysis.py`. The reference parses
compiled, SPMD-partitioned HLO, where one instruction is about one kernel.
The port has no HLO; eager PyTorch runs one kernel per aten op, so the
reference's "one instruction ~= one kernel" holds literally here. `OpCounter`
is a dispatch mode that sees every op a step runs and sums

* **flops**      — per matmul-type op (mm, bmm, addmm, baddbmm, convolution,
                   attention), `torch.utils.flop_counter`'s formulas;
* **hbm_bytes**  — operand + result bytes of each op on the reference's
                   traffic list (products, copies, gathers / scatters,
                   concatenation, padding, reductions, sorts, random draws,
                   collectives). Elementwise ops are left out, as the
                   reference leaves them out for being fused into their
                   producers; eager PyTorch runs them as kernels of their own,
                   so the figure is a floor of what eager moves;
* **ici_bytes**  — collective payload bytes (x2 for all-reduce: ring
                   reduce-scatter + all-gather), split by kind;
* **peak_bytes** — the most bytes of tensor storage alive at once, from the
                   storages the ops make (and those registered with `track`):
                   what eager PyTorch holds, not XLA's buffer assignment.

Per device, not global: on a DTensor op the mode steps aside and counts the
ops DTensor then runs on the local shards, and the collectives it issues.
`FlopCounterMode` around DTensor ops counts the global (logical) work, which
is wrong here by the number of ranks. DTensor also runs each new op once at
global shapes to learn its output's metadata; those runs are not counted.
Every op runs under a `FakeTensorMode` in the dry run, so nothing is
allocated and the counts are of shapes.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# Ops that move HBM bytes, by the reference's HLO opcode they correspond to:
# dot, convolution, copy / transpose, (dynamic-)slice, (dynamic-)update-
# slice, gather, scatter, concatenate, pad, reduce, sort, rng.
_TRAFFIC_OPS = {
    # dot
    aten.mm, aten.bmm, aten.addmm, aten.baddbmm,
    # convolution
    aten.convolution, aten.convolution_backward,
    # copy / transpose (a view is free; a copy or a contiguous is a kernel)
    aten.copy_, aten.clone, aten._to_copy,
    # dynamic-update-slice
    aten.slice_scatter, aten.select_scatter,
    # gather
    aten.index, aten.index_select, aten.gather, aten.embedding,
    aten.embedding_dense_backward,
    # scatter
    aten.index_put_, aten.index_put, aten.scatter, aten.scatter_,
    aten.scatter_add, aten.scatter_add_, aten.index_add, aten.index_add_,
    # concatenate / pad
    aten.cat, aten.stack, aten.constant_pad_nd,
    # reduce
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
    aten.logsumexp, aten._softmax, aten._log_softmax,
    aten._softmax_backward_data, aten._log_softmax_backward_data,
    aten.cumsum, aten.topk,
    # sort
    aten.sort, aten.argsort,
    # rng
    aten.randn, aten.rand, aten.normal_, aten.uniform_,
}

# collective op -> (kind, payload factor); the payload is the result's
# bytes, as the reference counts an HLO collective's result shape
_FUNCOL = torch.ops._c10d_functional
_C10D = torch.ops.c10d
_COLLECTIVES = {
    _FUNCOL.all_gather_into_tensor: ("all_gather_into_tensor", 1.0),
    _FUNCOL.reduce_scatter_tensor: ("reduce_scatter_tensor", 1.0),
    _FUNCOL.all_reduce: ("all_reduce", 2.0),
    _FUNCOL.all_to_all_single: ("all_to_all", 1.0),
    _C10D.allreduce_: ("all_reduce", 2.0),
    _C10D._allgather_base_: ("all_gather_into_tensor", 1.0),
    _C10D._reduce_scatter_base_: ("reduce_scatter_tensor", 1.0),
    _C10D.alltoall_base_: ("all_to_all", 1.0),
}
COLLECTIVE_KINDS = ("all_gather_into_tensor", "reduce_scatter_tensor",
                    "all_reduce", "all_to_all")


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


@dataclass
class OpCounts:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    ici_bytes: float = 0.0
    by_collective: Dict[str, float] = field(default_factory=dict)
    collective_count: int = 0
    op_count: int = 0
    live_bytes: int = 0
    peak_bytes: int = 0


_meta_run = threading.local()


@contextlib.contextmanager
def not_counted():
    """Ops run inside are DTensor's bookkeeping, not the step's work: the
    counter lets them through uncounted."""
    depth = getattr(_meta_run, "depth", 0)
    _meta_run.depth = depth + 1
    try:
        yield
    finally:
        _meta_run.depth = depth


@contextlib.contextmanager
def _mark_metadata_runs():
    """Flag DTensor's own runs of an op at global shapes (to learn its
    output's shape, stride and type) so that the counter skips them."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def wrapped(self, *args, **kwargs):
        with not_counted():
            return orig(self, *args, **kwargs)

    ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


class OpCounter(TorchDispatchMode):
    """Counts the ops run under it, per device (see the module docstring).
    Use as `with OpCounter() as c: ...`; the totals are in `c.counts`."""

    def __init__(self):
        super().__init__()
        self.counts = OpCounts()
        self._live: Dict[int, int] = {}
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(_mark_metadata_runs())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    # ----------------------------------------------------------- memory
    def _forget(self, key: int) -> None:
        self.counts.live_bytes -= self._live.pop(key, 0)

    def track(self, tree) -> None:
        """Count the storages of the tensors in `tree` (a DTensor's local
        shard) as live from now until they are freed."""
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                self._note(t)

    def _note(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._live:
            return
        n = s.nbytes()
        self._live[key] = n
        weakref.finalize(s, self._forget, key)
        c = self.counts
        c.live_bytes += n
        c.peak_bytes = max(c.peak_bytes, c.live_bytes)

    # --------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(_meta_run, "depth", 0):
            return func(*args, **kwargs)
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in leaves):
            return NotImplemented       # DTensor runs it on local shards
        out = func(*args, **kwargs)
        c = self.counts
        c.op_count += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            c.flops += float(flop_registry[packet](*args, **kwargs,
                                                   out_val=out))
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if packet in _TRAFFIC_OPS or packet in _COLLECTIVES:
            c.hbm_bytes += sum(_bytes(a) for a in leaves) + sum(
                _bytes(o) for o in outs if not any(o is a for a in leaves))
        if packet in _COLLECTIVES:
            kind, factor = _COLLECTIVES[packet]
            payload = sum(_bytes(o) for o in outs) * factor
            c.ici_bytes += payload
            c.by_collective[kind] = c.by_collective.get(kind, 0.0) + payload
            c.collective_count += 1
        for o in outs:
            self._note(o)
        return out
