"""`flash_attention` and `paged_attention` refuse the same inputs on the CPU
as on the card.

Each wrapper checks ranks, shapes, GQA divisibility, head size, dtypes,
`window` and `lengths` before it sends a CPU tensor to its plain version, so
an input the CUDA kernel refuses is refused here too, with the same exception
type and message: the checks are one piece of code ahead of the device
branch. Only the stride and alignment checks, which describe the kernel's
loads, come after it. Head size 8 (phi4-mini's and qwen2.5-32b's smoke
configs) and 80 (hubert's) are sizes the reference's Pallas kernels take and
the port's do not (ROADMAP B1/B3). `ops.paged_attention`, the model
layer's glue, casts `lengths` to int32 before the wrapper sees it, as the
reference's glue does."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import HEAD_DIMS as FLASH_DIMS
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import HEAD_DIMS as PAGED_DIMS
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


@pytest.mark.parametrize("d", [8, 80])
def test_flash_refuses_a_head_size_its_kernel_lacks(d):
    assert d not in FLASH_DIMS
    with pytest.raises(ValueError, match=f"head dim {d} not in"):
        flash_attention(*_flash(d))


def test_flash_refuses_a_negative_window():
    with pytest.raises(ValueError, match="window must be >= 0, got -3"):
        flash_attention(*_flash(), causal=True, window=-3)


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16)])
def test_flash_refuses_mixed_or_unsupported_dtypes(q_dtype, kv_dtype):
    with pytest.raises(TypeError, match="must share float32 or bfloat16"):
        flash_attention(*_flash(16, q_dtype, kv_dtype))


@pytest.mark.parametrize("shape_k", [(B, 3, S, 16), (B, HKV, S + 1, 16),
                                     (B, HKV, S, 32)],
                         ids=["gqa", "S!=T", "head"])
def test_flash_refuses_shapes_that_do_not_fit(shape_k):
    q, _, _ = _flash()
    k = _t(shape_k)
    with pytest.raises(ValueError, match="does not fit"):
        flash_attention(q, k, k.clone())


@pytest.mark.parametrize("d", [8, 80])
def test_paged_refuses_a_head_size_its_kernel_lacks(d):
    assert d not in PAGED_DIMS
    with pytest.raises(ValueError, match=f"head dim {d} not in"):
        paged_attention(*_paged(d))


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
    q, k, v, lengths = _paged()
    with pytest.raises(TypeError, match="must share float32 or bfloat16"):
        paged_attention(q, k.to(torch.bfloat16), v.to(torch.bfloat16),
                        lengths)


def test_accepted_inputs_still_reach_the_plain_versions():
    q, k, v = _flash()
    out = flash_attention(q, k, v, causal=True, window=4)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert torch.equal(out, ref.attention_ref(q, k, v, causal=True,
                                              window=4))
    q, kc, vc, lengths = _paged()
    out = paged_attention(q, kc, vc, lengths)
    assert torch.equal(out, ref.paged_attention_ref(q, kc, vc, lengths))
