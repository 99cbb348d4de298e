"""`repro_torch.models.moe` against `repro.models.moe` on the same seeded
numpy inputs and weights (carried across by `repro_torch.convert`): the
router, both dispatch paths, the capacity and which pairs it keeps, for the
smoke configs of granite (32 experts top-8 at full width) and kimi (with a
shared expert)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import configs, convert
from repro_torch.models import lm, moe

from test_torch_util import (BF16_TOL, FP32_TOL, jax_tree_to_numpy,
                             random_like, to_jax, to_np, to_torch)

ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]


def _setup(arch, dtype="float32", capacity_factor=None, seed=0):
    """(cfg, jcfg, torch params, jax params, x as numpy [B, S, d]) with the
    weights cast for compute as both entry points cast them."""
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
    rng = np.random.default_rng(seed)
    shapes = jax_tree_to_numpy(jmoe.init_moe(jcfg, jax.random.PRNGKey(0)))
    weights = random_like(shapes, rng)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    params = lm.cast_params_for_compute(
        convert.params_from_numpy(weights, device="cpu"), tdt)
    jparams = jlm.cast_params_for_compute(to_jax(weights), jdt)
    return cfg, jcfg, params, jparams, x


def _route_both(arch, dtype="float32"):
    cfg, jcfg, params, jparams, x = _setup(arch, dtype)
    xt = x.reshape(-1, cfg.d_model)
    got = moe.route(cfg, params, to_torch(xt, getattr(torch, dtype)))
    want = jax.jit(functools.partial(jmoe.route, jcfg))(
        jparams, jnp.asarray(xt, getattr(jnp, dtype)))
    return cfg, xt, params, got, want


def _gap_message(cfg, xt, params, experts, jexperts):
    """Where the top-k sets differ: the router's probabilities there and the
    gap between the k-th and (k+1)-th, which a flip needs to be tiny."""
    probs = torch.softmax(to_torch(xt).float() @ params["router"].float(), -1)
    rows = np.nonzero((experts != jexperts).any(1))[0]
    top = torch.sort(probs[rows], -1, descending=True).values
    k = cfg.moe.top_k
    gaps = (top[:, k - 1] - top[:, k]).tolist() if k < probs.shape[1] else []
    return (f"top-k experts differ in tokens {rows.tolist()}: "
            f"{experts[rows].tolist()} vs {jexperts[rows].tolist()}; "
            f"probability gap between the k-th and next: {gaps}")


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    cfg, xt, params, (w, e, aux), (jw, je, jaux) = _route_both(arch)
    experts, jexperts = to_np(e), np.asarray(je)
    assert np.array_equal(experts, jexperts), _gap_message(
        cfg, xt, params, experts, jexperts)
    assert w.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(to_np(w), to_np(jw), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    # descending, renormalised
    assert (np.diff(to_np(w), axis=1) <= 0).all()
    np.testing.assert_allclose(to_np(w).sum(1), 1.0, atol=1e-6)


def test_route_takes_a_bf16_router_as_an_fp32_product():
    """`cast_params_for_compute` casts the 2-D router to bf16; routing still
    multiplies in fp32 and gives x's type back."""
    cfg, xt, params, (w, e, aux), (jw, je, jaux) = _route_both(
        "granite-moe-1b-a400m", "bfloat16")
    assert params["router"].dtype == torch.bfloat16
    assert w.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert np.array_equal(to_np(e), np.asarray(je)), _gap_message(
        cfg, xt, params, to_np(e), np.asarray(je))
    np.testing.assert_allclose(to_np(w), to_np(jw), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["dense", "capacity"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_matches_reference(arch, mode, dtype):
    cfg, jcfg, params, jparams, x = _setup(arch, dtype)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out, aux = moe.apply_moe(cfg, params, to_torch(x, tdt), mode=mode)
    jout, jaux = jax.jit(functools.partial(jmoe.apply_moe, jcfg, mode=mode))(
        jparams, jnp.asarray(x, jdt))
    assert out.dtype == tdt and out.shape == x.shape
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(to_np(out), to_np(jout), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)


def _reference_keep(jcfg, experts, T):
    """The kept mask of the reference's capacity path, its own lines
    (`src/repro/models/moe.py`, `apply_moe_capacity`) on its own experts."""
    m = jcfg.moe
    C = max(1, int(np.ceil(T * m.top_k / m.num_experts * m.capacity_factor)))
    flat_e = experts.reshape(-1)
    one_hot = jax.nn.one_hot(flat_e, m.num_experts, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(one_hot, axis=0) - 1
    mypos = jnp.take_along_axis(pos_in_e, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(mypos < C), C


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_the_reference_pairs(arch):
    """At capacity factor 0.5 an expert's queue is half its fair share, so
    pairs are dropped: the same pairs on both sides, the same output."""
    cfg, jcfg, params, jparams, x = _setup(arch, capacity_factor=0.5)
    T = x.shape[0] * x.shape[1]
    xt = to_torch(x.reshape(T, -1))
    _, experts, _ = moe.route(cfg, params, xt)
    flat_tok, slot, keep, C = moe.dispatch(cfg, experts)
    _, jexperts, _ = jmoe.route(jcfg, jparams, jnp.asarray(x.reshape(T, -1)))
    jkeep, jC = _reference_keep(jcfg, jexperts, T)
    assert C == jC == moe.capacity(cfg, T)
    assert not jkeep.all(), "no pair was dropped; the case tests nothing"
    np.testing.assert_array_equal(to_np(keep), jkeep)
    k = cfg.moe.top_k
    np.testing.assert_array_equal(to_np(flat_tok), np.repeat(np.arange(T), k))
    kept = to_np(slot)[to_np(keep)]
    assert len(set(kept.tolist())) == kept.size            # one pair a slot
    assert (to_np(slot)[~to_np(keep)] == cfg.moe.num_experts * C).all()
    out, _ = moe.apply_moe_capacity(cfg, params, to_torch(x))
    jout, _ = jax.jit(functools.partial(jmoe.apply_moe_capacity, jcfg))(
        jparams, jnp.asarray(x))
    np.testing.assert_allclose(to_np(out), to_np(jout), **FP32_TOL)


@pytest.mark.parametrize("T", [1, 4, 7, 32, 4000])
def test_capacity_is_the_reference_expression(T):
    """C = max(1, ceil(T * k / E * capacity_factor)); at granite's full
    width and batch 4, decode (T = 4) keeps 2 pairs an expert."""
    for arch in ARCHS:
        for get in ("get_config", "get_smoke_config"):
            m = getattr(jconfigs, get)(arch).moe
            want = max(1, int(np.ceil(T * m.top_k / m.num_experts
                                      * m.capacity_factor)))
            assert moe.capacity(getattr(configs, get)(arch), T) == want
    assert moe.capacity(configs.get_config("granite-moe-1b-a400m"), 4) == 2


def test_combine_is_the_same_on_every_run():
    """A token's k outputs are summed in pair order, so two runs give the
    same bits (no atomics whose order could change)."""
    cfg, _, params, _, x = _setup("granite-moe-1b-a400m", "bfloat16")
    xb = to_torch(x, torch.bfloat16)
    a, _ = moe.apply_moe_capacity(cfg, params, xb)
    b, _ = moe.apply_moe_capacity(cfg, params, xb)
    assert torch.equal(a, b)


def test_init_moe_tree_matches_reference():
    for arch in ARCHS:
        cfg, jcfg = (configs.get_smoke_config(arch),
                     jconfigs.get_smoke_config(arch))
        mine = moe.init_moe(cfg, torch.Generator().manual_seed(0),
                            torch.bfloat16, device="cpu")
        theirs = jmoe.init_moe(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
        a, _ = convert.flatten(mine)
        b, _ = jax.tree.flatten(theirs)
        assert [tuple(t.shape) for t in a] == [t.shape for t in b]
        assert [str(t.dtype).split(".")[-1] for t in a] == \
            [t.dtype.name for t in b]
