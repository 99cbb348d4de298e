"""The 16-bit integer add of `csrc/async_scatter.cu` (`add16_rows`), modelled
word by word in numpy: a returning 32-bit add of each aligned word that
holds part of an update row and, where the low half carried into the high
one, a repair that takes the carry out again; a word only the row's high
half touches takes a plain add. The L2 runs these in any order, each repair
some time after its add. The model must give the lane-wise wrapping int16 /
uint16 sum in every order, and the same rule over bytes (what int8 would
take) must not: the source's note gives the order that breaks it.

Then the 8-bit integer and fp8 add (`cas_rows`): lanes that each keep a
batch of compare-and-swaps in flight (every fresh word's load issued
before any is read, every CAS before any return is read, a lost word
retried from the returned word beside the next batch's fresh ones),
interleaved one memory operation at a time at random. int8 / uint8 must
end as the lane-wise wrapping sum in every order, fp8 as one add and
rounding an update in the order the CASes won, each update winning once.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

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


# ------------------------------------------------- the batched CAS (int8, fp8)
CAS_BATCH = 8                                # csrc/async_scatter.cu's


def add_table(kind) -> np.ndarray:
    """[256, 256] uint8: byte a plus byte b as the kernel adds a byte of
    `kind` (`__vadd4` for int8 / uint8, wrapping; fp8 widened to fp32,
    added and rounded back without saturation, `ref.to_fp8`)."""
    a = np.arange(256, dtype=np.uint8)
    if kind == "int8":
        return (a[:, None].astype(np.int32) + a[None, :]).astype(np.uint8)
    x = torch.from_numpy(a).view(kind).float()
    return ref.to_fp8(x[:, None] + x[None, :], kind).view(
        torch.uint8).numpy()


def add_word(table: np.ndarray, old: int, w: int, inside: int,
             unit: int = 4) -> int:
    """`add_bytes`: each byte of the row (0xff in `inside`) of old plus
    that of w, over a unit of `unit` bytes; the others kept."""
    out = old
    for i in range(unit):
        if (inside >> (8 * i)) & 0xFF:
            s = int(table[(old >> (8 * i)) & 0xFF, (w >> (8 * i)) & 0xFF])
            out = (out & ~(0xFF << (8 * i))) | (s << (8 * i))
    return out & ((1 << (8 * unit)) - 1)


def row_words(row: int, upd: bytes, R: int, unit: int = 4):
    """The aligned units of `unit` bytes of the table (index) that hold
    part of row `row` of R bytes, each with the update's bytes in place and
    `inside` (`row_word` of the source; units of 8 or 16 bytes only where R
    is a whole number of them, as `cas_rows` takes them)."""
    at = row * R
    lead = at % unit
    assert unit == 4 or lead == 0
    out = []
    for k in range(-(-(lead + R) // unit)):
        w = inside = 0
        for i in range(unit):
            o = k * unit + i - lead
            if 0 <= o < R:
                w |= upd[o] << (8 * i)
                inside |= 0xFF << (8 * i)
        out.append(((at - lead) // unit + k, w, inside))
    return out


def cas_lane(words, table, mode="retry", unit=4):
    """One lane of `cas_rows` as a generator of its memory operations:
    yields ("load", word) and ("cas", word, expect, new, uid) and is sent
    the word read / the word before the CAS. `words`: the lane's (word, w,
    inside, uid) in order. mode "retry" is the source; "drop" forgets a
    word whose CAS lost; "first" retries it from its first load, not from
    the return."""
    it = iter(words)
    places = [None] * CAS_BATCH              # [word, w, inside, uid, seen]
    while True:
        for i in range(CAS_BATCH):           # fresh words: their loads
            if places[i] is None:
                nxt = next(it, None)
                if nxt is not None:
                    seen = yield ("load", nxt[0])
                    places[i] = [*nxt, seen]
        live = [i for i in range(CAS_BATCH) if places[i] is not None]
        if not live:
            return
        got = {}
        for i in live:                       # every CAS, then the returns
            word, w, inside, uid, seen = places[i]
            got[i] = yield ("cas", word, seen,
                            add_word(table, seen, w, inside, unit), uid)
        for i in live:
            if got[i] == places[i][4] or mode == "drop":
                places[i] = None
            elif mode == "retry":
                places[i][4] = got[i]


def run_lanes(mem, lanes, rng, max_ops=200_000):
    """Runs the lanes' generators on `mem` (a list of words), one memory
    operation of a lane drawn at random at a time; returns the (word, uid)
    of the CASes that won, in order, or None past max_ops (a lane that
    never finishes)."""
    wins, ops = [], {}
    for j, lane in enumerate(lanes):
        try:
            ops[j] = next(lane)
        except StopIteration:
            pass
    n = 0
    while ops:
        n += 1
        if n > max_ops:
            return None
        j = int(rng.choice(list(ops)))
        op = ops[j]
        if op[0] == "load":
            back = mem[op[1]]
        else:
            _, word, expect, new, uid = op
            back = mem[word]
            if back == expect:
                mem[word] = new
                wins.append((word, uid))
        try:
            ops[j] = lanes[j].send(back)
        except StopIteration:
            del ops[j]
    return wins


def draw_cas_case(rng, R: int, hot: bool, n: int = 48, lanes: int = 4,
                  unit: int = 4):
    """n updates of R bytes into a table of 16 rows (hot: into 2 of them,
    so that a lane's batch holds one word twice), dealt to `lanes` lanes
    as the apply kernel deals them (update u to lane u % lanes); the
    table's units of `unit` bytes, and each lane's (unit, w, inside, uid)
    in order."""
    nrows = 16
    mem = [int.from_bytes(rng.integers(0, 256, unit, dtype=np.uint8)
                          .tobytes(), "little")
           for _ in range(-(-nrows * R // unit) + 1)]
    rows = rng.integers(0, 2 if hot else nrows, n)
    upds = [bytes(rng.integers(0, 256, R, dtype=np.uint8)) for _ in range(n)]
    per_lane = [[] for _ in range(lanes)]
    for u in range(n):
        for word, w, inside in row_words(int(rows[u]), upds[u], R, unit):
            per_lane[u % lanes].append((word, w, inside, u))
    return mem, per_lane


@pytest.mark.parametrize("kind", ["int8", torch.float8_e4m3fn,
                                  torch.float8_e5m2],
                         ids=["int8", "e4m3", "e5m2"])
@pytest.mark.parametrize("R,unit", [(8, 4), (3, 4), (6, 4), (16, 16),
                                    (32, 16)],
                         ids=["words", "3-byte", "6-byte", "16-byte-units",
                              "32-byte-rows"])
@pytest.mark.parametrize("hot", [True, False], ids=["hot", "uniform"])
def test_batched_cas_adds_each_update_once_in_any_order(kind, R, unit, hot):
    """Lanes of batched compare-and-swaps, interleaved at random one memory
    operation at a time: every update's word wins exactly one CAS; int8 /
    uint8 (one byte rule: per-byte wrapping) ends as the lane-wise wrapping
    sum whatever the order; fp8 ends as the adds replayed one at a time,
    each rounded, in the order the CASes won. Hot rows put one word twice
    into a lane's batch; 3- and 6-byte rows share words with neighbours,
    whose bytes are kept. Rows of whole 16-byte units take one
    compare-and-swap a unit (atom.cas.b128)."""
    table = add_table(kind)
    rng = np.random.default_rng(R * 10 + hot + (0 if kind == "int8"
                                                else 5 + kind.itemsize))
    twice = 0
    for trial in range(12):
        mem, per_lane = draw_cas_case(rng, R, hot, unit=unit)
        init = list(mem)
        for words in per_lane:               # a word twice in one batch
            for b0 in range(0, len(words), CAS_BATCH):
                batch = [x[0] for x in words[b0:b0 + CAS_BATCH]]
                twice += len(batch) != len(set(batch))
        wins = run_lanes(mem, [cas_lane(w, table, unit=unit)
                               for w in per_lane], rng)
        want_wins = sorted((x[0], x[3]) for w in per_lane for x in w)
        assert sorted(wins) == want_wins, trial
        updates = {(x[0], x[3]): x for w in per_lane for x in w}
        replay = list(init)
        for key in wins:
            word, w, inside, _ = updates[key]
            replay[word] = add_word(table, replay[word], w, inside, unit)
        assert mem == replay, trial
        if kind == "int8":                   # the same in any order
            direct = list(init)
            for word, w, inside, _ in sorted(updates.values(),
                                             key=lambda x: -x[3]):
                direct[word] = add_word(table, direct[word], w, inside,
                                        unit)
            assert mem == direct, trial
    assert twice > 0 or not hot


@pytest.mark.parametrize("mode", ["drop", "first"])
def test_batched_cas_needs_its_retry_from_the_return(mode):
    """The two broken batches of chip_smoke.py's mutants: forgetting a
    word whose CAS lost drops updates of hot words, and retrying it from
    its first load in place of the returned word never wins again (the
    lane spins: on the card the run is killed at its time limit)."""
    table = add_table("int8")
    rng = np.random.default_rng(7)
    broken = 0
    for trial in range(6):
        mem, per_lane = draw_cas_case(rng, 8, True)
        init = list(mem)
        wins = run_lanes(mem, [cas_lane(w, table, mode) for w in per_lane],
                         rng, max_ops=20_000)
        if mode == "first":
            broken += wins is None
            continue
        direct = list(init)
        for w in per_lane:
            for word, w_, inside, _ in w:
                direct[word] = add_word(table, direct[word], w_, inside)
        broken += mem != direct
    assert broken > 0
