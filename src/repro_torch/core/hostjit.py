"""Optional host-side JIT kernels for the fused epoch step.

The epoch-fused command plane (``EpochScheduler`` ->
``BatchedAsyncMemoryEngine.flush_epoch`` -> ``FarMemoryModel.issue_epoch``)
bottoms out in two scalar-sequential recurrences that numpy cannot fuse
across segment boundaries without changing float association:

* the per-link injection chain ``inject_i = max(now_i, free[link_i]);
  free[link_i] = inject_i + serial_i`` (link serialization across an
  arbitrary interleaving of segments and links), and
* the MLP ledger's issue-time accumulation, which must stay a sequential
  left-to-right float sum to remain bit-identical to n scalar ``record()``
  calls.

Both are pure float loops, so they JIT well. When :mod:`numba` is
importable and the ``AmuConfig.host_jit`` knob is on, the loops run as
``@njit`` kernels; otherwise the callers fall back to the pure-numpy
per-(segment x link) ``np.cumsum`` chunks / Python accumulation loop.
Every operation is a sequential IEEE binary add or max in the same order,
so the JIT and fallback paths are bit-identical — pinned by
tests/test_epoch_fusion.py.

numba is an *optional* dev dependency (see requirements-dev.txt); this
module must import cleanly without it.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

_chain_fn: Optional[Callable] = None
_seq_sum_fn: Optional[Callable] = None
_probed = False


def _probe() -> None:
    """Compile the kernels once, lazily, iff numba is importable."""
    global _chain_fn, _seq_sum_fn, _probed
    if _probed:
        return
    _probed = True
    try:
        from numba import njit
    except ImportError:
        return

    @njit(cache=True)
    def _chain(nows, serial, links, free, out):  # pragma: no cover - jitted
        for i in range(nows.size):
            f = free[links[i]]
            inj = nows[i] if nows[i] > f else f   # == max(now, free)
            out[i] = inj
            free[links[i]] = inj + serial[i]

    @njit(cache=True)
    def _seq_sum(values, init):                   # pragma: no cover - jitted
        acc = init
        for i in range(values.size):
            acc = acc + values[i]
        return acc

    # warm the dispatcher so first use inside a timed sweep isn't a compile
    _chain(np.zeros(1), np.zeros(1), np.zeros(1, np.int64), np.zeros(1),
           np.zeros(1))
    _seq_sum(np.zeros(1), 0.0)
    _chain_fn = _chain
    _seq_sum_fn = _seq_sum


def numba_available() -> bool:
    _probe()
    return _chain_fn is not None


def get_chain(enabled: bool) -> Optional[Callable]:
    """The jitted injection-chain kernel, or None (use the numpy path).

    Signature: ``chain(nows, serial, links, free, out)`` with ``nows``,
    ``serial``, ``out`` float64[n], ``links`` int64[n] (link index per row)
    and ``free`` float64[n_links] updated in place. Bit-identical to the
    scalar loop ``inj = max(now_i, free[l]); free[l] = inj + serial_i``.
    """
    if not enabled:
        return None
    _probe()
    return _chain_fn


def get_seq_sum(enabled: bool) -> Optional[Callable]:
    """The jitted sequential float accumulator, or None (Python loop).

    ``seq_sum(values, init) -> float`` performs ``init + v0 + v1 + ...``
    as strictly sequential binary adds — the ledger's bit-identity
    contract with n scalar ``record()`` calls.
    """
    if not enabled:
        return None
    _probe()
    return _seq_sum_fn
