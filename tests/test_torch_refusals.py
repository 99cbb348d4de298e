"""`flash_attention` and `paged_attention` refuse the same inputs on the CPU
as on the card.

Each wrapper checks ranks, shapes, GQA divisibility, head size, dtypes,
`window` and `lengths` before it sends a CPU tensor to its plain version, so
an input the CUDA kernel refuses is refused here too, with the same exception
type and message: the checks are one piece of code ahead of the device
branch. Only the stride and alignment checks, which describe the kernel's
loads, come after it. Both kernels take every head size from 1 up, in
float32, bfloat16, float16, float8 and 8-, 16- and 32-bit integers and with
q, k, v of different types, as the reference's Pallas kernels do; a head
size of 0 (the reference divides by sqrt(0)) and a 64-bit type (which the
reference makes 32-bit before any kernel runs) stay refused, and what the
kernels now take is held against the plain versions here.
`ops.paged_attention`, the model layer's glue, casts `lengths` to int32
before the wrapper sees it, as the reference's glue does."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import CHUNK_DIM, flash_attention
from repro_torch.kernels.paged_attention import paged_attention

B, HQ, HKV, S, T = 2, 4, 2, 32, 24


def _t(shape, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def _flash(d=16, q_dtype=torch.float32, kv_dtype=torch.float32):
    return (_t((B, HQ, S, d), q_dtype), _t((B, HKV, S, d), kv_dtype, 1),
            _t((B, HKV, S, d), kv_dtype, 2))


def _paged(d=16, dtype=torch.float32, lengths_dtype=torch.int32):
    return (_t((B, HQ, d), dtype), _t((B, T, HKV, d), dtype, 1),
            _t((B, T, HKV, d), dtype, 2),
            torch.tensor([T, 5], dtype=lengths_dtype))


@pytest.mark.parametrize("d", [0])
def test_flash_refuses_a_head_size_its_kernel_lacks(d):
    with pytest.raises(ValueError, match=f"head dim {d} is not positive"):
        flash_attention(*_flash(d))


@pytest.mark.parametrize("d", [CHUNK_DIM + 1, 2 * CHUNK_DIM])
def test_flash_takes_head_sizes_above_256(d):
    """257 was refused before the wide bodies; now it reaches the plain
    version on the CPU as any other head size does."""
    q, k, v = _flash(d)
    out = flash_attention(q, k, v, causal=True, window=4)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert torch.equal(out, ref.attention_ref(q, k, v, True, 4))


def test_flash_refuses_a_negative_window():
    with pytest.raises(ValueError, match="window must be >= 0, got -3"):
        flash_attention(*_flash(), causal=True, window=-3)


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float64), (torch.float64, torch.float32),
    (torch.int64, torch.int64)])
def test_flash_refuses_mixed_or_unsupported_dtypes(q_dtype, kv_dtype):
    """A type no body takes, alone or beside one that a body takes (int32,
    refused here before, is taken now: tests/test_torch_types.py)."""
    with pytest.raises(TypeError, match="takes float32, bfloat16, float16, "
                                        "float8_e4m3fn"):
        flash_attention(*_flash(16, q_dtype, kv_dtype))


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16)])
def test_flash_takes_mixed_and_float16_types(q_dtype, kv_dtype):
    """The inputs that were refused as mixed or float16: now taken, the
    result in q's type and equal to the plain version's."""
    q, k, v = _flash(16, q_dtype, kv_dtype)
    out = flash_attention(q, k, v)
    assert out.dtype == q_dtype
    assert torch.equal(out, ref.attention_ref(q, k, v))


@pytest.mark.parametrize("shape_k", [(B, 3, S, 16), (B, HKV, S + 1, 16),
                                     (B, HKV, S, 32)],
                         ids=["gqa", "S!=T", "head"])
def test_flash_refuses_shapes_that_do_not_fit(shape_k):
    q, _, _ = _flash()
    k = _t(shape_k)
    with pytest.raises(ValueError, match="does not fit"):
        flash_attention(q, k, k.clone())


@pytest.mark.parametrize("d", [0])
def test_paged_refuses_a_head_size_its_kernel_lacks(d):
    with pytest.raises(ValueError, match=f"head dim {d} is not positive"):
        paged_attention(*_paged(d))


@pytest.mark.parametrize("d", [CHUNK_DIM + 1, 2 * CHUNK_DIM])
def test_paged_takes_head_sizes_above_256(d):
    q, kc, vc, lengths = _paged(d)
    out = paged_attention(q, kc, vc, lengths)
    assert out.shape == q.shape
    assert torch.equal(out, ref.paged_attention_ref(q, kc, vc, lengths))


@pytest.mark.parametrize("lengths_dtype", [torch.int64, torch.int16])
def test_paged_refuses_lengths_that_are_not_int32(lengths_dtype):
    with pytest.raises(TypeError, match="lengths must be contiguous int32"):
        paged_attention(*_paged(lengths_dtype=lengths_dtype))


def test_paged_refuses_non_contiguous_lengths():
    q, k, v, _ = _paged()
    lengths = torch.tensor([T, 0, 5, 0], dtype=torch.int32)[::2]
    with pytest.raises(TypeError, match="lengths must be contiguous int32"):
        paged_attention(q, k, v, lengths)


def test_paged_refuses_mixed_dtypes():
    """Mixed float types are taken now (below); a cache of a type no body
    takes is refused beside a q that one takes."""
    q, k, v, lengths = _paged()
    with pytest.raises(TypeError, match="takes float32, bfloat16, float16, "
                                        "float8_e4m3fn"):
        paged_attention(q, k.to(torch.float64), v.to(torch.float64),
                        lengths)


@pytest.mark.parametrize("q_dtype,k_dtype,v_dtype", [
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.float16, torch.float16),
    (torch.bfloat16, torch.float32, torch.float16)])
def test_paged_takes_mixed_and_float16_types(q_dtype, k_dtype, v_dtype):
    q, k, v, lengths = _paged()
    q, k, v = q.to(q_dtype), k.to(k_dtype), v.to(v_dtype)
    out = paged_attention(q, k, v, lengths)
    assert out.dtype == q_dtype
    assert torch.equal(out, ref.paged_attention_ref(q, k, v, lengths))


def test_accepted_inputs_still_reach_the_plain_versions():
    q, k, v = _flash()
    out = flash_attention(q, k, v, causal=True, window=4)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert torch.equal(out, ref.attention_ref(q, k, v, causal=True,
                                              window=4))
    q, kc, vc, lengths = _paged()
    out = paged_attention(q, kc, vc, lengths)
    assert torch.equal(out, ref.paged_attention_ref(q, kc, vc, lengths))


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A (1,) DeviceMesh over a one-rank gloo group, torn down after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def _dtensor_cases():
    from repro_torch.kernels import ops
    q, k, v = (t.transpose(1, 2) for t in _flash())
    pq, kc, vc, lengths = _paged()
    table = _t((64, 8))
    idx = torch.tensor([3, 1, 7], dtype=torch.int32)
    return {
        "flash_attention": (ops.flash_attention, (q, k, v)),
        "paged_attention": (ops.paged_attention, (pq, kc, vc, lengths)),
        "gather": (ops.gather, (table, idx)),
        "scatter_update": (ops.scatter_update, (table, idx, _t((3, 8), seed=4))),
        "triad": (lambda b, c: ops.triad(b, c, 2.0), (_t((100,)),
                                                      _t((100,), seed=1))),
    }


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention",
                                  "gather", "scatter_update", "triad"])
def test_wrappers_refuse_a_dtensor(one_rank_mesh, name):
    """A DTensor never reaches a kernel (its pointer is a wrapper's, not a
    card's memory): each `ops` wrapper raises TypeError for one, before its
    CPU dispatch, so the CPU refuses what the card refuses. The same plain
    inputs still run."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    fn, args = _dtensor_cases()[name]
    for i in range(len(args)):
        bad = list(args)
        bad[i] = distribute_tensor(args[i], one_rank_mesh, [Replicate()])
        with pytest.raises(TypeError, match=f"{name} takes plain tensors"):
            fn(*bad)
    assert fn(*args) is not None
