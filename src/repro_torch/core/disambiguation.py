"""Software-based memory disambiguation (§5.1).

A CAM-free conflict tracker for in-flight asynchronous requests: a multi-table
cuckoo hash *set* of active far-memory addresses. Unlike classic cuckoo
hashing, each hash function owns its own table (the paper's variation):
insertion tries table 0 with h0, then table 1 with h1, ... — no displacement
chains, so lookups/inserts are O(#tables) with tiny constants.

Each occupied slot carries a FIFO of waiters (coroutine handles) so that
conflicting requests serialize in program order, mirroring Listing 1:

    start_access(addr)  -> True if acquired, else the caller must suspend
    end_access(addr)    -> returns the next waiter to resume (or None)

Aliasing granularity is configurable (cache line by default): two accesses
conflict iff they touch the same aligned block.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Hashable, List, Optional

# 64-bit mix constants (splitmix64 finalizer) — cheap, well-dispersing
_MIX = (0xBF58476D1CE4E5B9, 0x94D049BB133111EB, 0xFF51AFD7ED558CCD,
        0xC4CEB9FE1A85EC53)
_MASK = (1 << 64) - 1


def _mix64(x: int, c: int) -> int:
    x &= _MASK
    x ^= x >> 30
    x = (x * c) & _MASK
    x ^= x >> 27
    x = (x * c) & _MASK
    x ^= x >> 31
    return x


@dataclass
class _Entry:
    addr: int
    holders: int = 1                      # current owner count (always 1 here)
    waiters: Deque[Hashable] = field(default_factory=deque)


class CuckooAddressSet:
    """Multi-table cuckoo hash set of active (in-flight) block addresses."""

    def __init__(self, slots_per_table: int = 1024, num_tables: int = 4,
                 block_bytes: int = 64):
        assert slots_per_table & (slots_per_table - 1) == 0, "power of two"
        self.num_tables = num_tables
        self.slots = slots_per_table
        self.block_shift = (block_bytes - 1).bit_length()
        self.tables: List[Dict[int, _Entry]] = [dict() for _ in range(num_tables)]
        # stats (Table 5's overhead accounting reads these)
        self.probes = 0
        self.inserts = 0
        self.conflicts = 0
        self.overflow_inserts = 0  # all tables collided -> spill dict
        self._spill: Dict[int, _Entry] = {}

    def _block(self, addr: int) -> int:
        return addr >> self.block_shift

    def _slot(self, block: int, table: int) -> int:
        return _mix64(block, _MIX[table % len(_MIX)]) & (self.slots - 1)

    def _find(self, block: int) -> Optional[_Entry]:
        for t in range(self.num_tables):
            self.probes += 1
            e = self.tables[t].get(self._slot(block, t))
            if e is not None and e.addr == block:
                return e
        return self._spill.get(block)

    # -- Listing 1 API -------------------------------------------------------
    def start_access(self, addr: int, waiter: Hashable = None) -> bool:
        """Try to acquire `addr`'s block. On conflict, enqueue `waiter` and
        return False (caller suspends). On success return True."""
        block = self._block(addr)
        entry = self._find(block)
        if entry is not None:
            self.conflicts += 1
            entry.waiters.append(waiter)
            return False
        self.inserts += 1
        for t in range(self.num_tables):
            slot = self._slot(block, t)
            if slot not in self.tables[t]:
                self.tables[t][slot] = _Entry(block)
                return True
        self.overflow_inserts += 1
        self._spill[block] = _Entry(block)
        return True

    def end_access(self, addr: int) -> Optional[Hashable]:
        """Release `addr`'s block. If someone is waiting, ownership transfers
        to the head waiter (entry stays); returns that waiter for resumption.
        Otherwise the entry is removed and None is returned."""
        block = self._block(addr)
        for t in range(self.num_tables):
            slot = self._slot(block, t)
            e = self.tables[t].get(slot)
            if e is not None and e.addr == block:
                if e.waiters:
                    return e.waiters.popleft()
                del self.tables[t][slot]
                return None
        e = self._spill.get(block)
        if e is None:
            raise KeyError(f"end_access on non-active block {block:#x}")
        if e.waiters:
            return e.waiters.popleft()
        del self._spill[block]
        return None

    def active_count(self) -> int:
        return sum(len(t) for t in self.tables) + len(self._spill)
