"""The 8- and 16-bit integer triad of `csrc/stream_triad.cu` (`triad_word`),
modelled word by word in numpy: a 32-bit word holds 4 int8 or 2 int16
lanes; its even lanes (mask 0x00FF00FF, or 0x0000FFFF) take one
multiply-add of the masked b and c by s's low 8 (16) bits, its odd lanes
(the other mask) another, and each lane keeps the low bits of its own sum.
The model must be the reference's triad bit for bit (two's-complement wrap
after s is made the type's, toward zero and saturated) over every (b, c)
pair of int8 and uint8 and a grid of 16-bit values, and a word-wide
multiply-add without the masks (a carry that crosses lanes) must not.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stream_triad import stream_triad as jtriad
from repro_torch.kernels import ref

MASK32 = 0xFFFFFFFF
LANES = {1: 0x00FF00FF, 2: 0x0000FFFF}      # the even lanes of a word
# s as the reference takes it: a float made the type's toward zero and
# saturated (300 -> 127 in int8, 255 in uint8; -300 -> -128 or 0), so also
# negative and saturating ones
SCALARS = (3.3, -0.7, -3.0, 2.0, 300.0, -300.0, 1e6, -1e6, 129.0, -1.5)


def triad_words(b: np.ndarray, c: np.ndarray, s: int, item: int) -> np.ndarray:
    """The kernel's arithmetic on arrays of uint32 words: s the lanes' bits
    (s mod 2^(8 item))."""
    m = np.uint64(LANES[item])
    nm = np.uint64(~LANES[item] & MASK32)
    s = np.uint64(s & ((1 << (8 * item)) - 1))
    b, c = b.astype(np.uint64), c.astype(np.uint64)
    even = ((b & m) + (c & m) * s) & np.uint64(MASK32)
    odd = ((b & nm) + (c & nm) * s) & np.uint64(MASK32)
    return ((even & m) | (odd & nm)).astype(np.uint32)


def word_wide(b: np.ndarray, c: np.ndarray, s: int, item: int) -> np.ndarray:
    """The same without the masks: one 32-bit multiply-add of the words by
    s in every lane, so a lane's carry reaches the next."""
    lanes = 4 // item
    s = s & ((1 << (8 * item)) - 1)
    sw = sum(s << (8 * item * i) for i in range(lanes)) & MASK32
    return ((b.astype(np.uint64) + c.astype(np.uint64) * np.uint64(sw))
            & np.uint64(MASK32)).astype(np.uint32)


def all_pairs(name: str):
    """Every (b, c) pair of an 8-bit type, 65536 of each."""
    v = np.arange(256, dtype=np.uint8).view(name)
    return np.repeat(v, 256), np.tile(v, 256)


def grid_pairs(name: str):
    """Every pair of a grid of 16-bit values: the type's ends, the values
    next to 0, +-2^7, +-2^8 and +-2^15, and 104 seeded ones (128 in all:
    16384 pairs, whole blocks of the reference's kernel)."""
    edges = np.array([-32768, -32767, -30000, -257, -256, -255, -129, -128,
                      -127, -2, -1, 0, 1, 2, 127, 128, 129, 255, 256, 257,
                      1000, 30000, 32766, 32767], np.int64)
    rng = np.random.default_rng(28)
    v = np.concatenate([edges, rng.integers(-32768, 32768, 104)])
    v = v.astype(np.int16).view(name)
    return np.repeat(v, v.size), np.tile(v, v.size)


def pairs(name: str):
    return all_pairs(name) if np.dtype(name).itemsize == 1 \
        else grid_pairs(name)


def _triad_ref(b: np.ndarray, c: np.ndarray, s: float) -> np.ndarray:
    """The port's plain version (held against the reference's kernel in
    interpret mode by tests/test_torch_types.py)."""
    return ref.triad_ref(torch.from_numpy(b), torch.from_numpy(c), s).numpy()


def _model(b: np.ndarray, c: np.ndarray, s: float, fn=triad_words):
    item = b.dtype.itemsize
    si = ref.round_scalar(s, getattr(torch, b.dtype.name))
    return fn(b.view(np.uint32), c.view(np.uint32), si, item).view(b.dtype)


@pytest.mark.parametrize("name", ["int8", "uint8", "int16", "uint16"])
@pytest.mark.parametrize("s", SCALARS)
def test_word_triad_is_the_reference_bit_for_bit(name, s):
    """Every (b, c) pair of int8 / uint8 (a grid at 16 bits), four lanes (two)
    a word: the model equals the plain version in every lane."""
    b, c = pairs(name)
    np.testing.assert_array_equal(_model(b, c, s), _triad_ref(b, c, s))


@pytest.mark.parametrize("name", ["int8", "uint8", "int16", "uint16"])
@pytest.mark.parametrize("s", [3.3, -3.0])
def test_word_triad_is_the_reference_kernel(name, s):
    """The same pairs through the reference's Pallas kernel in interpret
    mode (N = 65536 at 8 bits, 16384 at 16, blocks of 512)."""
    b, c = pairs(name)
    want = np.asarray(jtriad(jnp.asarray(b), jnp.asarray(c), s,
                             interpret=True))
    np.testing.assert_array_equal(_model(b, c, s), want)


@pytest.mark.parametrize("name", ["int8", "uint8", "int16", "uint16"])
def test_word_wide_add_crosses_lanes(name):
    """Without the lane masks a lane's carry reaches the next one: the
    word-wide multiply-add differs from the reference at these inputs (so
    phase 5 of chip_smoke.py, whose inputs span the whole type, catches a
    kernel that drops them)."""
    b, c = pairs(name)
    want = _triad_ref(b, c, 3.3)
    got = _model(b, c, 3.3, word_wide)
    assert (got != want).mean() > 0.1
    np.testing.assert_array_equal(_model(b, c, 3.3), want)
