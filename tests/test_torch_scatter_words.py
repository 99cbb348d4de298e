"""The 16-bit integer add of `csrc/async_scatter.cu` (`add16_rows`), modelled
word by word in numpy: a returning 32-bit add of each aligned word that
holds part of an update row and, where the low half carried into the high
one, a repair that takes the carry out again; a word only the row's high
half touches takes a plain add. The L2 runs these in any order, each repair
some time after its add. The model must give the lane-wise wrapping int16 /
uint16 sum in every order, and the same rule over bytes (what int8 would
take) must not: the source's note gives the order that breaks it.
"""
from __future__ import annotations

import numpy as np
import pytest

MASK32 = 0xFFFFFFFF
LOW, HIGH, BOTH = 0x0000FFFF, 0xFFFF0000, 0xFFFFFFFF


def word_ops(w: int, inside: int):
    """The operations of one update on its word, as the kernel issues them:
    [("red", v)] for a word only the row's high half touches, else
    [("atom", w), ("repair",)] (the repair reads the atom's return)."""
    if inside == HIGH:
        return [("red", w)]
    return [("atom", w), ("repair",)]


def run_word(init: int, updates, order) -> int:
    """Applies the updates' operations to a word in `order` (a list of
    (update, step) pairs, each update's steps in order). A repair adds
    0xffff0000 where its atom's low half plus the update's low half passed
    0xffff."""
    word, seen = init, {}
    ops = [word_ops(w, inside) for w, inside in updates]
    for u, step in order:
        op = ops[u][step]
        if op[0] == "red":
            word = (word + op[1]) & MASK32
        elif op[0] == "atom":
            seen[u] = word
            word = (word + op[1]) & MASK32
        else:
            lo = updates[u][0] & 0xFFFF
            if (seen[u] & 0xFFFF) + lo > 0xFFFF:
                word = (word + 0xFFFF0000) & MASK32
    return word


def random_order(rng, updates):
    """An interleaving of the updates' steps: at each turn the next step of
    an update drawn at random, so a repair may land any time after its
    atom, before or after any other update's steps."""
    left = [len(word_ops(w, inside)) for w, inside in updates]
    done = [0] * len(updates)
    order = []
    while any(done[u] < left[u] for u in range(len(updates))):
        live = [u for u in range(len(updates)) if done[u] < left[u]]
        u = int(rng.choice(live))
        order.append((u, done[u]))
        done[u] += 1
    return order


def lane_sum(init: int, updates, dtype) -> int:
    """The reference: each 16-bit lane of the word summed in `dtype`,
    wrapping; a lane outside an update's row gets nothing from it."""
    lanes = np.array([init & 0xFFFF, init >> 16], np.uint16).view(dtype)
    for w, inside in updates:
        add = np.array([w & 0xFFFF, w >> 16], np.uint16).view(dtype)
        keep = np.array([inside & 0xFFFF, inside >> 16]) != 0
        with np.errstate(over="ignore"):
            lanes = np.where(keep, lanes + add, lanes).astype(dtype)
    lo, hi = (int(x) for x in lanes.view(np.uint16))
    return lo | hi << 16


def draw_updates(rng, n: int, kinds, carrying: bool):
    """n updates of the word, each of a kind of `kinds` (BOTH: the word
    wholly in the row; LOW: the row's last element, beside a neighbour's;
    HIGH: the row's first element), its halves from [0x8000, 0xffff] where
    `carrying` (every add of the low half carries) else the whole range."""
    lo_min = 0x8000 if carrying else 0
    out = []
    for _ in range(n):
        inside = int(rng.choice(kinds))
        lo, hi = (int(x) for x in rng.integers(lo_min, 0x10000, 2))
        w = (lo if inside & LOW else 0) | (hi << 16 if inside & HIGH else 0)
        out.append((w, inside))
    return out


@pytest.mark.parametrize("dtype", [np.int16, np.uint16])
@pytest.mark.parametrize("kinds", [(BOTH,), (LOW,), (HIGH,), (LOW, HIGH),
                                   (BOTH, LOW, HIGH)],
                         ids=["whole", "low", "high", "low-high", "mixed"])
@pytest.mark.parametrize("carrying", [True, False],
                         ids=["carrying", "any"])
def test_add16_word_rule_is_the_wrapping_sum_in_any_order(dtype, kinds,
                                                          carrying):
    """Many updates of one word, wholly or partly inside their rows, in
    random interleavings and in the two extreme ones (every atom before
    any repair; each repair right after its atom): the word always ends as
    the lane-wise wrapping sum of its halves, the neighbour's half of a
    partly covered word bit for bit."""
    rng = np.random.default_rng(len(kinds) * 10 + carrying)
    for trial in range(60):
        init = int(rng.integers(0, 1 << 32))
        updates = draw_updates(rng, int(rng.integers(1, 12)), kinds,
                               carrying)
        want = lane_sum(init, updates, dtype)
        steps = [(u, s) for u, (w, inside) in enumerate(updates)
                 for s in range(len(word_ops(w, inside)))]
        atoms_first = sorted(steps, key=lambda us: (us[1], us[0]))
        orders = [steps, atoms_first] + [random_order(rng, updates)
                                         for _ in range(20)]
        for order in orders:
            assert run_word(init, updates, order) == want, (trial, order)


def test_add16_repair_is_needed_and_lands_on_the_high_half():
    """Without the repair the low half's carry stays in the high half;
    with it a neighbour beside a lone low-half element keeps its bits."""
    init = 0x1234FFFF                        # neighbour 0x1234, row's 0xffff
    updates = [(0x0001, LOW)]                # the row's last element, + 1
    order = [(0, 0), (0, 1)]
    assert run_word(init, updates, order) == 0x12340000
    assert run_word(init, updates, order[:1]) == 0x12350000   # no repair


def byte_rule(init: int, updates, order) -> int:
    """The same rule over bytes (int8: a carry out of each of bytes 0-2 of
    the row repaired by subtracting it from the next byte), each update's
    carries taken from its atom's return."""
    word, seen = init, {}
    for u, step in order:
        w, inside = updates[u]
        if step == 0:
            seen[u] = word
            word = (word + w) & MASK32
            continue
        for i in range(3):
            if (inside >> (8 * i)) & 0xFF:
                a, b = (seen[u] >> (8 * i)) & 0xFF, (w >> (8 * i)) & 0xFF
                if a + b > 0xFF:
                    word = (word - (1 << (8 * (i + 1)))) & MASK32
    return word


def test_the_byte_rule_breaks_on_the_source_notes_order():
    """The counterexample in the note of csrc/async_scatter.cu, which is
    why int8 keeps its CAS loop: bytes [0xff, 0xff, 0, 0]; A adds 1 to
    byte 0, B adds 1 to byte 1; A's atom, B's atom (B sees byte 1 at 0:
    no carry), B's repair, A's repair. Byte 2 ends at 1 where the lane-wise
    sum leaves it 0. In A-then-B order the rule is right."""
    init = 0x0000FFFF
    updates = [(0x00000001, 0x000000FF), (0x00000100, 0x0000FF00)]
    want = 0x00000000                        # each byte wraps on its own
    assert byte_rule(init, updates, [(0, 0), (0, 1), (1, 0), (1, 1)]) == want
    got = byte_rule(init, updates, [(0, 0), (1, 0), (1, 1), (0, 1)])
    assert got == 0x00010000 != want
