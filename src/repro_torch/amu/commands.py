"""Typed per-coroutine command facade: ``ctx.aload(...)`` instead of raw
command-object construction.

A port body is a generator that yields AMI commands; the facade is the one
place that knows which concrete command class each operation lowers to, so
port authors write::

    data = yield ctx.spm_read(slot, 8)          # read-only view, zero-copy
    yield ctx.aload(slot, addr, 8)              # issue + await (one hop)
    tok = yield ctx.aload(slot, addr, 8, wait=False)   # issue, keep running
    yield ctx.await_rid(tok)
    yield ctx.aload_vec(slots, addrs, 8)        # whole vector, one hop
    yield ctx.acquire_vec(locks)                # whole lock set, one hop

instead of hand-picking between ``Aload``/``AloadNoWait``/``AloadVec`` and
friends. Every method returns the command object ("handle") to yield; the
lowering is 1:1, so facade-written ports stay trace-identical to ports that
construct the command dataclasses directly.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.coroutines import (Acquire, AcquireVec, Aload, AloadNoWait,
                                         AloadVec, Astore, AstoreNoWait, AstoreVec,
                                         AwaitRid, AwaitRids, Cost, Now, Release,
                                         ReleaseVec, SpmRead, SpmWrite, WaitUntil)


class CommandFacade:
    """Stateless constructor facade over the AMI command set (§5.2)."""

    # -------------------------------------------------- asynchronous moves
    @staticmethod
    def aload(spm: int, mem: int, size: Optional[int] = None, *,
              wait: bool = True):
        """Far memory -> SPM. ``wait=True`` suspends until completion;
        ``wait=False`` resumes immediately with a wait token (pair with
        :meth:`await_rid`).

        Under fault injection (a region with a :class:`FaultModel`), a
        ``wait=True`` yield resumes with the request's final AMART status
        (``STATUS_OK`` / ``STATUS_ERROR`` / ``STATUS_TIMED_OUT`` — after
        any scheduler retries/failover); failed requests move no data.
        Zero-fault configs resume with ``None`` exactly as before."""
        return Aload(spm, mem, size) if wait else AloadNoWait(spm, mem, size)

    @staticmethod
    def astore(spm: int, mem: int, size: Optional[int] = None, *,
               wait: bool = True):
        """SPM -> far memory; see :meth:`aload` for ``wait``."""
        return Astore(spm, mem, size) if wait else AstoreNoWait(spm, mem, size)

    @staticmethod
    def aload_vec(spm, mem, size: Optional[int] = None, *,
                  wait: bool = True):
        """One AMI vector command for ``len(spm)`` loads (§4.2 metadata
        batching). ``wait=True`` fuses the await (one generator hop per
        vector); ``wait=False`` returns wait tokens for :meth:`await_rids`.

        Under fault injection a fused-await yield resumes with a per-lane
        ``int8`` status array (lane-aligned with ``spm``); zero-fault
        configs resume with ``None``."""
        return AloadVec(spm, mem, size, wait)

    @staticmethod
    def astore_vec(spm, mem, size: Optional[int] = None, *,
                   wait: bool = True):
        """Vectorized astore; see :meth:`aload_vec`."""
        return AstoreVec(spm, mem, size, wait)

    @staticmethod
    def await_rid(tok):
        """Suspend until the token from a ``wait=False`` issue completes.
        Under fault injection the yield resumes with that request's final
        status int (``None`` on zero-fault configs)."""
        return AwaitRid(tok)

    @staticmethod
    def await_rids(toks):
        """Suspend until EVERY token completes (one coroutine resume).
        Under fault injection the yield resumes with a per-token ``int8``
        status array (``None`` on zero-fault configs)."""
        return AwaitRids(tuple(toks) if not hasattr(toks, "dtype") else toks)

    # ------------------------------------------------ software lock plane
    @staticmethod
    def acquire(addr: int):
        """start_access on `addr`'s 64B block (Listing 1)."""
        return Acquire(addr)

    @staticmethod
    def release(addr: int):
        """end_access; FIFO hand-off to the head waiter."""
        return Release(addr)

    @staticmethod
    def acquire_vec(addrs):
        """Acquire a whole ascending block-deduped lock set in one hop
        (see ``workloads._lock_set`` for how to produce one)."""
        return AcquireVec(addrs)

    @staticmethod
    def release_vec(addrs):
        """Release a whole lock set (FIFO hand-offs included) in one hop."""
        return ReleaseVec(addrs)

    # --------------------------------------------------- synchronous SPM
    @staticmethod
    def spm_read(spm: int, size: int):
        """Read-only numpy view aliasing live SPM (zero-copy contract)."""
        return SpmRead(spm, size)

    @staticmethod
    def spm_write(spm: int, data):
        """Register->SPM store; `data` is bytes or a C-contiguous ndarray."""
        return SpmWrite(spm, data)

    # ------------------------------------------------------------- compute
    @staticmethod
    def cost(insts: float = 0.0, cycles: float = 0.0):
        """Charge plain compute between memory ops."""
        return Cost(insts, cycles)

    # ------------------------------------------------------------ the clock
    @staticmethod
    def wait_until(cycles: float):
        """Suspend until the core clock reaches the ABSOLUTE time `cycles`
        (continues immediately if it is already past — open-loop arrival)."""
        return WaitUntil(cycles)

    @staticmethod
    def now():
        """Resume with the current core clock in cycles (free: a
        cycle-counter read) — timestamp request completions with it."""
        return Now()


#: Singleton facade — ports do ``from repro_torch.amu import ctx``.
ctx = CommandFacade()
