"""An index outside [0, N) in `ops.gather` / `ops.scatter_update`.

The port's contract is the CUDA kernels': such an index traps
(`csrc/async_gather.cu`, `csrc/async_scatter.cu`), so on the CPU the
wrappers raise `IndexError` before any row is written, for gather and for
scatter add and xor alike. Beside each refusal the reference's behaviour in
Pallas interpret mode is recorded: its gather clamps (row 63 of a 64-row
table), and its scatter, whose glue pads with a sink row, changes no row."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

from test_torch_util import to_np

N, BLOCK_M = 64, 8


def _table(dtype):
    return np.arange(N * 2, dtype=dtype).reshape(N, 2)


@pytest.mark.parametrize("bad", [-1, N, N + 1])
@pytest.mark.parametrize("op", ["gather", "add", "xor"])
def test_index_outside_the_table_is_refused(op, bad):
    idx = np.array([1, bad, 3], np.int32)
    upd = np.full((3, 2), 5, np.int32)
    table = _table(np.int32) if op == "gather" else np.zeros((N, 2), np.int32)
    t = torch.from_numpy(table.copy())
    with pytest.raises(IndexError, match=f"index {bad} is outside"):
        if op == "gather":
            ops.gather(t, torch.from_numpy(idx), block_m=BLOCK_M)
        else:
            ops.scatter_update(t, torch.from_numpy(idx), torch.from_numpy(upd),
                               op=op, block_m=BLOCK_M)
    assert np.array_equal(t.numpy(), table)           # nothing written

    # the reference, for the record: clamp in gather, drop in scatter
    if op == "gather":
        got = np.asarray(jops.gather(jnp.asarray(table), jnp.asarray(idx),
                                     block_m=BLOCK_M))
        np.testing.assert_array_equal(got[1], table[N - 1])
    else:
        got = np.asarray(jops.scatter_update(
            jnp.asarray(table), jnp.asarray(idx), jnp.asarray(upd), op=op,
            block_m=BLOCK_M))
        assert np.nonzero(got.any(1))[0].tolist() == [1, 3]


def test_xor_minus_one_changes_no_last_row():
    """The worst case of the fault this repairs: xor with index -1 used to
    change row 63, which the reference never touches."""
    t = torch.zeros((N, 2), dtype=torch.int32)
    with pytest.raises(IndexError):
        ops.scatter_update(t, torch.tensor([1, -1, 3], dtype=torch.int32),
                           torch.full((3, 2), 5, dtype=torch.int32), op="xor",
                           block_m=BLOCK_M)
    assert not t.any()
    # indices inside the table still work, at both ends
    out = ops.scatter_update(t, torch.tensor([0, N - 1], dtype=torch.int32),
                             torch.full((2, 2), 5, dtype=torch.int32),
                             op="xor", block_m=BLOCK_M)
    assert np.nonzero(to_np(out).any(1))[0].tolist() == [0, N - 1]
    got = ops.gather(out, torch.tensor([N - 1, 0], dtype=torch.int32))
    assert got.tolist() == [[5, 5], [5, 5]]
