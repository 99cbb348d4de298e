"""`repro_torch.models.rwkv6` against `repro.models.rwkv6` on the same seeded
numpy inputs and weights: token shift, projections, the per-token and the
chunk-parallel recurrence (output and final state), and the block with and
without a state under both `RWKV_CONFIG["impl"]`s. The knob is set on both
modules alike, by monkeypatch."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rwkv6 as jrwkv
from repro_torch import configs, convert
from repro_torch.models import rwkv6

from test_torch_util import (BF16_TOL, FP32_TOL, jax_tree_to_numpy,
                             random_like, to_jax, to_np, to_torch)

ARCH = "rwkv6-7b"


def _setup(seed=0):
    cfg, jcfg = configs.get_smoke_config(ARCH), jconfigs.get_smoke_config(ARCH)
    shapes = jax_tree_to_numpy(jrwkv.init_rwkv6(jcfg, jax.random.PRNGKey(0)))
    weights = random_like(shapes, np.random.default_rng(seed))
    return cfg, jcfg, weights


def _rkvw(cfg, B, S, rng):
    """r, k, v ~ N(0, 1) and a decay w in [0.9, 1) as the chunk-parallel
    form needs it, [B, S, H, N] fp32; a state [B, H, N, N]."""
    H, N = cfg.num_heads, cfg.resolved_head_dim
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.9, 1.0, (B, S, H, N)).astype(np.float32)
    s = rng.standard_normal((B, H, N, N)).astype(np.float32)
    return r, k, v, w, s


@pytest.mark.parametrize("with_last", [False, True])
def test_token_shift_matches_reference(with_last):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    last = rng.standard_normal((2, 1, 8)).astype(np.float32)
    got = rwkv6._token_shift(to_torch(x), to_torch(last) if with_last
                             else None)
    want = jrwkv._token_shift(jnp.asarray(x), jnp.asarray(last) if with_last
                              else None)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_matches_reference(dtype):
    cfg, jcfg, weights = _setup()
    rng = np.random.default_rng(2)
    x, xp = (rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
             for _ in range(2))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    # the 2-D mix and projections in the working type, the 1-D decay in fp32
    params = {k: (to_torch(v, tdt) if v.ndim == 2 else to_torch(v))
              for k, v in weights.items()}
    jparams = {k: (jnp.asarray(v, jdt) if v.ndim == 2 else jnp.asarray(v))
               for k, v in weights.items()}
    got = rwkv6._project(cfg, params, to_torch(x, tdt), to_torch(xp, tdt))
    want = jrwkv._project(jcfg, jparams, jnp.asarray(x, jdt),
                          jnp.asarray(xp, jdt))
    for name, a, b in zip("rkvgw", got, want):
        assert str(a.dtype).split(".")[-1] == b.dtype.name, name
        tol = FP32_TOL if dtype == "float32" or name == "w" else BF16_TOL
        np.testing.assert_allclose(to_np(a), to_np(b), err_msg=name, **tol)


def test_rwkv6_chunk_matches_reference():
    cfg, jcfg, weights = _setup()
    r, k, v, w, s = _rkvw(cfg, 2, 12, np.random.default_rng(3))
    p = {"bonus": to_torch(weights["bonus"])}
    out, s_new = rwkv6.rwkv6_chunk(cfg, p, *map(to_torch, (r, k, v, w, s)))
    jout, js_new = jax.jit(functools.partial(jrwkv.rwkv6_chunk, jcfg))(
        {"bonus": jnp.asarray(weights["bonus"])},
        *map(jnp.asarray, (r, k, v, w, s)))
    np.testing.assert_allclose(to_np(out), np.asarray(jout), **FP32_TOL)
    np.testing.assert_allclose(to_np(s_new), np.asarray(js_new), **FP32_TOL)


@pytest.mark.parametrize("S,chunk", [(16, 4), (16, 16), (24, 8)])
def test_rwkv6_chunk_parallel_matches_reference(S, chunk):
    cfg, jcfg, weights = _setup()
    r, k, v, w, s = _rkvw(cfg, 2, S, np.random.default_rng(4))
    p = {"bonus": to_torch(weights["bonus"])}
    out, s_new = rwkv6.rwkv6_chunk_parallel(
        cfg, p, *map(to_torch, (r, k, v, w, s)), chunk)
    jout, js_new = jax.jit(functools.partial(
        jrwkv.rwkv6_chunk_parallel, jcfg, chunk=chunk))(
        {"bonus": jnp.asarray(weights["bonus"])},
        *map(jnp.asarray, (r, k, v, w, s)))
    np.testing.assert_allclose(to_np(out), np.asarray(jout), **FP32_TOL)
    np.testing.assert_allclose(to_np(s_new), np.asarray(js_new), **FP32_TOL)
    # the same math as the per-token recurrence, in the port alone
    out2, s2 = rwkv6.rwkv6_chunk(cfg, p, *map(to_torch, (r, k, v, w, s)))
    np.testing.assert_allclose(to_np(out), to_np(out2), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(to_np(s_new), to_np(s2), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl", ["scan", "chunked"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 16, 20])
def test_apply_rwkv6_matches_reference(impl, with_state, S, monkeypatch):
    """S = 16 is a whole number of chunks of 8 and takes the chunk-parallel
    form under "chunked"; S = 20 is not, and S = 1 is decode: both run the
    per-token recurrence whatever the knob says, on both sides."""
    for conf in (rwkv6.RWKV_CONFIG, jrwkv.RWKV_CONFIG):
        monkeypatch.setitem(conf, "impl", impl)
        monkeypatch.setitem(conf, "chunk", 8)
    cfg, jcfg, weights = _setup()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    state = jstate = None
    if with_state:
        st = {"s": rng.standard_normal(
                  (2, cfg.num_heads, cfg.resolved_head_dim,
                   cfg.resolved_head_dim)).astype(np.float32),
              "last_x": rng.standard_normal(
                  (2, 1, cfg.d_model)).astype(np.float32)}
        state = {k: to_torch(v) for k, v in st.items()}
        jstate = to_jax(st)
        kept = {k: v.clone() for k, v in state.items()}
    out, new = rwkv6.apply_rwkv6(cfg, convert.params_from_numpy(
        weights, device="cpu"), to_torch(x), state)
    jout, jnew = jax.jit(functools.partial(jrwkv.apply_rwkv6, jcfg))(
        to_jax(weights), jnp.asarray(x), jstate)
    np.testing.assert_allclose(to_np(out), np.asarray(jout), **FP32_TOL)
    if not with_state:
        assert new is None and jnew is None
        return
    for name in ("s", "last_x"):
        assert new[name].dtype == torch.float32
        np.testing.assert_allclose(to_np(new[name]), np.asarray(jnew[name]),
                                   **FP32_TOL)
        assert torch.equal(state[name], kept[name])   # the input is not written


def test_init_rwkv6_tree_and_state_match_reference():
    cfg, jcfg = configs.get_smoke_config(ARCH), jconfigs.get_smoke_config(ARCH)
    mine = rwkv6.init_rwkv6(cfg, torch.Generator().manual_seed(0),
                            torch.bfloat16, device="cpu")
    theirs = jrwkv.init_rwkv6(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    for tree, jtree in ((mine, theirs),
                        (rwkv6.init_rwkv6_state(cfg, 3, device="cpu"),
                         jrwkv.init_rwkv6_state(jcfg, 3))):
        a, _ = convert.flatten(tree)
        b, _ = jax.tree.flatten(jtree)
        assert [tuple(t.shape) for t in a] == [t.shape for t in b]
        assert [str(t.dtype).split(".")[-1] for t in a] == \
            [t.dtype.name for t in b]
    # the decay stays in (0, 1) and near 1 at init: exp(-exp([-8, -4]))
    assert -8.0 <= float(mine["decay_base"].min())
    assert float(mine["decay_base"].max()) <= -4.0
    assert not mine["bonus"].any()
