"""`repro_torch.models.lm` against `repro.models.lm` on converted weights:
prefill logits, decode steps and greedy tokens for the smoke configs of the
dense, MoE, vision, RWKV-6 and RecurrentGemma (RG-LRU + sliding-window
attention) architectures, the audio encoder's forward, plus
`repro_torch.convert`."""
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
# MoE (kimi with its shared expert), vision prefix + M-RoPE, attention-free,
# hybrid RG-LRU + sliding window (window 16 at smoke size)
NEW = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b", "qwen2-vl-2b", "rwkv6-7b",
       "recurrentgemma-9b"]
# fp32 on both sides; the sums of a 3-layer model run in another order
LOGITS_TOL = dict(atol=2e-4, rtol=1e-4)
# bf16 rounds at other places in the two frameworks (the reference's own
# cached-vs-uncached test uses the same bound)
BF16_LOGITS_TOL = dict(atol=0.15, rtol=0.05)
N_DECODE = 4


def _smoke_cfgs(arch):
    """(port, reference) smoke configs; "<arch>+tail" makes the pattern two
    blocks long over three layers, so one layer runs unstacked as the tail;
    "<arch>+L<n>" keeps the pattern and gives the model n layers;
    "<arch>+hd<n>" gives it head size n."""
    name, *tails = arch.split("+")
    cfg, jcfg = configs.get_smoke_config(name), jconfigs.get_smoke_config(name)
    for tail in tails:
        if tail.startswith("hd"):
            change = dict(head_dim=int(tail[2:]))
        elif tail.startswith("L"):
            change = dict(num_layers=int(tail[1:]))
        else:
            change = dict(block_pattern=(cfg.block_pattern[0],) * 2,
                          num_layers=3)
        cfg = dataclasses.replace(cfg, **change)
        jcfg = dataclasses.replace(jcfg, **change)
    return cfg, jcfg


def _weights(arch, seed=0):
    jcfg = _smoke_cfgs(arch)[1]
    shapes = jax_tree_to_numpy(jlm.init_model(jcfg, jax.random.PRNGKey(0)))
    return random_like(shapes, np.random.default_rng(seed))


def _inputs(cfg, B, S, rng):
    """Seeded numpy inputs: tokens, with `vision_embeds` for a vision
    frontend, or audio `features`."""
    if cfg.frontend is not None and cfg.frontend.kind == "audio":
        return {"features": rng.standard_normal(
            (B, S, cfg.frontend.feature_dim)).astype(np.float32)}
    inputs = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.frontend is not None:
        inputs["vision_embeds"] = rng.standard_normal(
            (B, cfg.frontend.prefix_len, cfg.frontend.feature_dim)
        ).astype(np.float32)
    return inputs


def _run_both(arch, prompt_len, use_kernels, dtype, follow_reference=False):
    """Prefill + N_DECODE greedy steps on both sides; yields per step the
    (port, reference) logits as numpy and the tokens each side chose. With
    `follow_reference` the port decodes the reference's tokens, so that a
    near tie that bf16 breaks the other way does not fork the two streams.

    The kernels take every head size from 1 to 256, so phi4-mini's and
    qwen2.5-32b's smoke configs run their kernel path at their own head
    size, 8."""
    cfg, jcfg = _smoke_cfgs(arch)
    weights = _weights(arch)
    rng = np.random.default_rng(1)
    B, max_len = 2, prompt_len + N_DECODE + 2
    inputs = _inputs(cfg, B, prompt_len, rng)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)

    params = convert.params_from_numpy(weights, device="cpu")
    cache = lm.init_cache(cfg, B, max_len, dtype=tdt, device="cpu")
    logits, cache = lm.prefill(cfg, params,
                               {k: to_torch(v) for k, v in inputs.items()},
                               cache, use_kernels=use_kernels, dtype=tdt)

    jparams = to_jax(weights)
    jcache = jlm.init_cache(jcfg, B, max_len, dtype=jdt)
    jprefill = jax.jit(functools.partial(
        jlm.prefill, jcfg, use_kernels=use_kernels, dtype=jdt))
    jdecode = jax.jit(functools.partial(
        jlm.decode_step, jcfg, use_kernels=use_kernels, dtype=jdt))
    jlogits, jcache = jprefill(jparams, to_jax(inputs), jcache)

    steps = [(to_np(logits), to_np(jlogits))]
    toks, jtoks = [], []
    for _ in range(N_DECODE):
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        jtok = jnp.argmax(jlogits[:, -1], -1)[:, None]
        toks.append(to_np(tok))
        jtoks.append(np.asarray(jtok))
        if follow_reference:
            tok = to_torch(np.asarray(jtok))
        logits, cache = lm.decode_step(cfg, params, tok, cache,
                                       use_kernels=use_kernels, dtype=tdt)
        jlogits, jcache = jdecode(jparams, jtok, jcache)
        steps.append((to_np(logits), to_np(jlogits)))
    return cfg, steps, np.concatenate(toks, 1), np.concatenate(jtoks, 1), \
        cache, jcache


# recurrentgemma at five layers: one period of (RG-LRU, RG-LRU, LOCAL) and
# a two-layer RG-LRU tail, as the full model's 38 = 12 * 3 + 2; qwen2.5-3b
# at head size 512, through the kernels' wide bodies
@pytest.mark.parametrize("arch", DENSE + ["qwen2.5-3b+tail"] + NEW + [
    "granite-moe-1b-a400m+tail", "rwkv6-7b+tail", "recurrentgemma-9b+L5",
    "phi4-mini-3.8b+hd16", "qwen2.5-3b+hd512"])
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


# float16 rounds at 2^-11 where bf16 rounds at 2^-8: the bf16 bound over 8
F16_LOGITS_TOL = dict(atol=0.15 / 8, rtol=0.05 / 8)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen2.5-3b+hd512"])
def test_prefill_and_decode_f16_with_kernels(arch):
    """A model cast to float16 (`cast_params_for_compute` takes any dtype)
    and served with `use_kernels=True`: flash at prefill (S = 128) and paged
    at decode in float16 (their plain versions on the CPU), against the
    reference's Pallas kernels in interpret mode on the same weights."""
    cfg, steps, toks, jtoks, cache, _ = _run_both(arch, 128, True, "float16",
                                                  follow_reference=True)
    assert cache["scan"][0]["k"].dtype == torch.float16
    for got, want in steps:
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **F16_LOGITS_TOL)


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_bf16_new_archs(arch):
    cfg, steps, toks, jtoks, cache, _ = _run_both(arch, 16, False,
                                                  "bfloat16",
                                                  follow_reference=True)
    for got, want in steps:
        np.testing.assert_allclose(got, want, **BF16_LOGITS_TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_forward_matches_reference(use_kernels, dtype):
    """hubert: audio frames through the bidirectional encoder, no cache. Not
    causal, so `use_kernels` never reaches flash on either side."""
    cfg, jcfg = _smoke_cfgs("hubert-xlarge")
    weights = _weights("hubert-xlarge")
    assert "embed" not in weights and "frontend" in weights
    inputs = _inputs(cfg, 2, 160, np.random.default_rng(2))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    logits, cache = lm.prefill(
        cfg, convert.params_from_numpy(weights, device="cpu"),
        {"features": to_torch(inputs["features"])}, None,
        use_kernels=use_kernels, dtype=tdt)
    assert cache is None and logits.shape == (2, 1, cfg.vocab_size)
    jlogits, _ = jax.jit(functools.partial(
        jlm.prefill, jcfg, use_kernels=use_kernels, dtype=jdt))(
        to_jax(weights), to_jax(inputs), None)
    tol = LOGITS_TOL if dtype == "float32" else BF16_LOGITS_TOL
    np.testing.assert_allclose(to_np(logits), to_np(jlogits), **tol)


@pytest.mark.parametrize("moe_mode", ["capacity", "dense"])
def test_forward_blocks_aux_matches_reference(moe_mode):
    """The MoE load-balancing loss summed over the layers, with the stream."""
    cfg, jcfg = _smoke_cfgs("granite-moe-1b-a400m")
    weights = _weights("granite-moe-1b-a400m")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    params = convert.params_from_numpy(weights, device="cpu")
    positions = lm.positions_for(cfg, 2, 16, device="cpu")
    out, cache, aux = lm.forward_blocks(cfg, params, to_torch(x), positions,
                                        moe_mode=moe_mode)
    jout, _, jaux = jax.jit(functools.partial(
        jlm.forward_blocks, jcfg, moe_mode=moe_mode))(
        to_jax(weights), jnp.asarray(x), jnp.asarray(to_np(positions)))
    assert cache is None and aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    np.testing.assert_allclose(to_np(out), to_np(jout), **LOGITS_TOL)
    dense = configs.get_smoke_config("qwen2.5-3b")
    _, _, dense_aux = lm.forward_blocks(
        dense, convert.params_from_numpy(_weights("qwen2.5-3b"),
                                         device="cpu"), to_torch(x), positions)
    assert float(dense_aux) == 0.0


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


@pytest.mark.parametrize("arch", DENSE + ["qwen2.5-3b-full"] + NEW + [
    "hubert-xlarge", "rwkv6-7b-full", "granite-moe-1b-a400m-full",
    "recurrentgemma-9b-full"])
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


def test_flatten_holds_no_leaf_once_its_caller_lets_go():
    """`flatten` / `unflatten` leave no reference cycle behind: a leaf is
    freed when its last holder drops it, without the cyclic collector (a
    cycle held the fp32 weights of a whole model beside their stacked copy
    and their bf16 cast: 71 GiB for rwkv6-7b on an 80 GB card)."""
    import gc
    import weakref
    t = torch.zeros(3)
    gone = weakref.ref(t)
    gc.disable()
    try:
        leaves, treedef = convert.flatten({"a": (t, [t]), "b": {"c": t}})
        back = convert.unflatten(treedef, leaves)
        assert back["a"][1][0] is t and back["b"]["c"] is t
        del t, leaves, back
        assert gone() is None
    finally:
        gc.enable()


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


def test_asking_for_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = configs.get_smoke_config("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_cache(cfg, 1, 8)
