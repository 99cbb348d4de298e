"""`repro_torch.models.lm` against `repro.models.lm` on converted weights:
prefill logits, decode steps and greedy tokens for the smoke configs of the
four dense architectures, plus `repro_torch.convert`."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs, convert
from repro_torch.models import lm

from test_torch_util import (jax_tree_to_numpy, random_like, to_jax, to_np,
                             to_torch)

DENSE = ["qwen2.5-3b", "qwen2-7b", "phi4-mini-3.8b", "qwen2.5-32b"]
# fp32 on both sides; the sums of a 3-layer model run in another order
LOGITS_TOL = dict(atol=2e-4, rtol=1e-4)
# bf16 rounds at other places in the two frameworks (the reference's own
# cached-vs-uncached test uses the same bound)
BF16_LOGITS_TOL = dict(atol=0.15, rtol=0.05)
N_DECODE = 4


def _smoke_cfgs(arch):
    """(port, reference) smoke configs; "<arch>+tail" makes the pattern two
    blocks long over three layers, so one layer runs unstacked as the tail."""
    name, _, tail = arch.partition("+")
    cfg, jcfg = configs.get_smoke_config(name), jconfigs.get_smoke_config(name)
    if tail:
        change = dict(block_pattern=("full", "full"), num_layers=3)
        cfg = dataclasses.replace(cfg, **change)
        jcfg = dataclasses.replace(jcfg, **change)
    return cfg, jcfg


def _weights(arch, seed=0):
    jcfg = _smoke_cfgs(arch)[1]
    shapes = jax_tree_to_numpy(jlm.init_model(jcfg, jax.random.PRNGKey(0)))
    return random_like(shapes, np.random.default_rng(seed))


def _run_both(arch, prompt_len, use_kernels, dtype):
    """Prefill + N_DECODE greedy steps on both sides; yields per step the
    (port, reference) logits as numpy and the tokens each side chose."""
    cfg, jcfg = _smoke_cfgs(arch)
    weights = _weights(arch)
    rng = np.random.default_rng(1)
    B, max_len = 2, prompt_len + N_DECODE + 2
    prompts = rng.integers(0, cfg.vocab_size, (B, prompt_len))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)

    params = convert.params_from_numpy(weights, device="cpu")
    cache = lm.init_cache(cfg, B, max_len, dtype=tdt, device="cpu")
    logits, cache = lm.prefill(cfg, params, {"tokens": to_torch(prompts)},
                               cache, use_kernels=use_kernels, dtype=tdt)

    jparams = to_jax(weights)
    jcache = jlm.init_cache(jcfg, B, max_len, dtype=jdt)
    jprefill = jax.jit(functools.partial(
        jlm.prefill, jcfg, use_kernels=use_kernels, dtype=jdt))
    jdecode = jax.jit(functools.partial(
        jlm.decode_step, jcfg, use_kernels=use_kernels, dtype=jdt))
    jlogits, jcache = jprefill(jparams, {"tokens": jnp.array(prompts)}, jcache)

    steps = [(to_np(logits), to_np(jlogits))]
    toks, jtoks = [], []
    for _ in range(N_DECODE):
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        jtok = jnp.argmax(jlogits[:, -1], -1)[:, None]
        toks.append(to_np(tok))
        jtoks.append(np.asarray(jtok))
        logits, cache = lm.decode_step(cfg, params, tok, cache,
                                       use_kernels=use_kernels, dtype=tdt)
        jlogits, jcache = jdecode(jparams, jtok, jcache)
        steps.append((to_np(logits), to_np(jlogits)))
    return cfg, steps, np.concatenate(toks, 1), np.concatenate(jtoks, 1), \
        cache, jcache


@pytest.mark.parametrize("arch", DENSE + ["qwen2.5-3b+tail"])
@pytest.mark.parametrize("use_kernels,prompt_len", [(False, 16), (True, 128)])
def test_prefill_and_decode_match_reference(arch, use_kernels, prompt_len):
    cfg, steps, toks, jtoks, cache, jcache = _run_both(
        arch, prompt_len, use_kernels, "float32")
    assert steps[0][0].shape == (2, 1, cfg.vocab_size)
    for i, (got, want) in enumerate(steps):
        np.testing.assert_allclose(got, want, err_msg=f"step {i}",
                                   **LOGITS_TOL)
    np.testing.assert_array_equal(toks, jtoks)      # greedy tokens identical
    leaves, _ = convert.flatten(cache)
    jleaves = jax.tree.leaves(jcache)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-4)


def test_prefill_and_decode_bf16():
    cfg, steps, toks, jtoks, cache, _ = _run_both(
        "qwen2.5-3b", 16, False, "bfloat16")
    assert cache["scan"][0]["k"].dtype == torch.bfloat16
    assert cache["len"].dtype == torch.int32
    for got, want in steps:
        np.testing.assert_allclose(got, want, **BF16_LOGITS_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(arch):
    """Decode step t must equal prefill of the t+1-long prefix (same model,
    cached vs uncached paths agree), in the default bf16."""
    cfg = configs.get_smoke_config(arch)
    gen = torch.Generator().manual_seed(1)
    params = lm.init_model(cfg, gen, device="cpu")
    B, S = 2, 16
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)))
    cache = lm.init_cache(cfg, B, S + 8, device="cpu")
    logits_p, cache = lm.prefill(cfg, params, {"tokens": tokens}, cache)
    tok = torch.argmax(logits_p[:, -1], -1)[:, None]
    logits_d, cache = lm.decode_step(cfg, params, tok, cache)
    assert cache["len"].tolist() == [S + 1] * B
    ext = torch.cat([tokens, tok], dim=1)
    cache2 = lm.init_cache(cfg, B, S + 8, device="cpu")
    logits_ref, _ = lm.prefill(cfg, params, {"tokens": ext}, cache2)
    np.testing.assert_allclose(to_np(logits_d[:, -1]),
                               to_np(logits_ref[:, -1]), atol=0.15, rtol=0.05)


def test_cast_params_for_compute_matches_reference_and_is_idempotent():
    weights = _weights("qwen2-7b")
    cast = lm.cast_params_for_compute(
        convert.params_from_numpy(weights, device="cpu"))
    jcast = jlm.cast_params_for_compute(to_jax(weights))
    leaves, _ = convert.flatten(cast)
    for a, b in zip(leaves, jax.tree.leaves(jcast)):
        assert str(a.dtype).split(".")[-1] == b.dtype.name
        np.testing.assert_array_equal(to_np(a), to_np(b))
    again, _ = convert.flatten(lm.cast_params_for_compute(cast))
    assert all(a is b for a, b in zip(leaves, again))


def test_param_counts_match_analytic():
    for arch in DENSE:
        cfg = configs.get_smoke_config(arch)
        params = lm.init_model(cfg, device="cpu")
        actual = sum(t.numel() for t in convert.flatten(params)[0])
        assert abs(actual - cfg.param_count()) / cfg.param_count() < 0.05


@pytest.mark.parametrize("arch", DENSE + ["qwen2.5-3b-full"])
def test_convert_leaf_order_equals_jax_tree_flatten(arch):
    """Offload pages are numbered by this order (dict keys sorted: `len`,
    then `scan` -> `k`, `v`)."""
    if arch.endswith("-full"):      # full-width cache layout at a tiny size
        jcfg = jconfigs.get_config(arch[:-5])
        cfg = configs.get_config(arch[:-5])
        jtree = jlm.init_cache(jcfg, 1, 2)
        tree = lm.init_cache(cfg, 1, 2, device="cpu")
    else:
        jcfg = jconfigs.get_smoke_config(arch)
        cfg = configs.get_smoke_config(arch)
        jtree = {"params": jlm.init_model(jcfg, jax.random.PRNGKey(0)),
                 "cache": jlm.init_cache(jcfg, 2, 8)}
        tree = {"params": lm.init_model(cfg, device="cpu"),
                "cache": lm.init_cache(cfg, 2, 8, device="cpu")}
    jleaves, _ = jax.tree.flatten(jtree)
    leaves, treedef = convert.flatten(tree)
    assert [tuple(t.shape) for t in leaves] == [tuple(t.shape)
                                                for t in jleaves]
    assert [str(t.dtype).split(".")[-1] for t in leaves] == \
        [t.dtype.name for t in jleaves]
    # converting the reference's tree gives the same order again
    conv, _ = convert.flatten(convert.cache_from_numpy(
        jax_tree_to_numpy(jtree), device="cpu"))
    assert [tuple(t.shape) for t in conv] == [tuple(t.shape) for t in leaves]
    back = convert.unflatten(treedef, leaves)
    assert all(a is b for a, b in zip(convert.flatten(back)[0], leaves))
    assert type(back) is type(tree) and sorted(back) == sorted(tree)


def test_convert_bf16_leaves_survive_bit_for_bit():
    rng = np.random.default_rng(0)
    x = jnp.array(rng.standard_normal((5, 7)) * 100, jnp.bfloat16)
    arr = np.asarray(x)                       # an ml_dtypes bfloat16 array
    assert arr.dtype.name == "bfloat16"
    tree = convert.cache_from_numpy(
        {"k": arr, "len": np.arange(3, dtype=np.int32)}, device="cpu")
    assert tree["k"].dtype == torch.bfloat16 and tree["len"].dtype == torch.int32
    np.testing.assert_array_equal(tree["k"].view(torch.int16).numpy().view(np.uint16),
                                  arr.view(np.uint16))
    # dtype= applies to floating leaves only
    p = convert.params_from_numpy({"w": arr, "n": np.arange(3)},
                                  device="cpu", dtype=torch.float32)
    assert p["w"].dtype == torch.float32 and p["n"].dtype == torch.int64
    np.testing.assert_array_equal(p["w"].numpy(), arr.astype(np.float32))


@pytest.mark.parametrize("fn", ["tensor_from_numpy", "params_from_numpy",
                                "cache_from_numpy"])
def test_convert_takes_no_default_device(fn):
    """The weight-carrying entry points name their device: forgetting it is a
    TypeError, not a silent landing on the CPU."""
    leaf = np.arange(3, dtype=np.float32)
    arg = leaf if fn == "tensor_from_numpy" else {"w": leaf}
    with pytest.raises(TypeError, match="device"):
        getattr(convert, fn)(arg)
    with pytest.raises(TypeError):
        getattr(convert, fn)(arg, "cpu")          # keyword only


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b",
                                  "granite-moe-1b-a400m", "kimi-k2-1t-a32b",
                                  "qwen2-vl-2b", "hubert-xlarge"])
def test_unported_architectures_raise(arch):
    cfg = configs.get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        lm.init_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        lm.init_cache(cfg, 1, 8, device="cpu")


def test_training_entry_points_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        lm.train_loss(None, None, None)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        lm.chunked_xent(None, None, None, None)


def test_asking_for_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = configs.get_smoke_config("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_cache(cfg, 1, 8)
