"""`repro_torch.optim.adamw` against `repro.optim.adamw` on the same numpy
inputs: the learning-rate schedule, the global-norm clip, several AdamW
steps on a tree with 1-D and stacked 3-D leaves (float32 and bfloat16
moments), and the int8 quantizer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.optim import adamw

from test_torch_util import FP32_TOL, to_jax, to_np, to_torch

CFG = dict(learning_rate=1e-2, warmup_steps=3, total_steps=12,
           grad_clip=1.0)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 4, 7, 11, 12, 20, 10000])
def test_schedule_matches_reference(step):
    """Warmup (0-2), the cosine (3-12) and the floor past the end, to the
    bit: the same float32 operations on an int32 step."""
    got = adamw.schedule(adamw.AdamWConfig(**CFG),
                         torch.tensor(step, dtype=torch.int32))
    want = jadamw.schedule(jadamw.AdamWConfig(**CFG),
                           jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7, atol=0)


def _tree(rng, scale=1.0):
    """A params-shaped tree: 1-D scales, 2-D matrices, a stacked [P, in,
    out] leaf under a tuple and a list."""
    def a(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"embed": a(16, 8), "final_norm": {"scale": a(8)},
            "scan": ({"mix": {"wq": a(3, 8, 8), "bq": a(3, 8)}},),
            "tail": [{"w": a(8, 4)}]}


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_by_global_norm_matches_reference(scale):
    """Below the limit the grads pass unchanged; above it they are scaled
    to norm 1. The port scales in place."""
    grads = _tree(np.random.default_rng(0), scale)
    got, gnorm = adamw.clip_by_global_norm(
        convert.params_from_numpy(grads, device="cpu"), 1.0)
    want, jnorm = jadamw.clip_by_global_norm(to_jax(grads), 1.0)
    np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=1e-6)
    for a, b in zip(convert.flatten(got)[0], jax.tree.leaves(want)):
        np.testing.assert_allclose(to_np(a), to_np(b), **FP32_TOL)
    norm = np.sqrt(sum(float((to_np(g) ** 2).sum())
                       for g in convert.flatten(got)[0]))
    assert norm == pytest.approx(min(1.0, float(jnorm)), rel=1e-5)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(moment_dtype, monkeypatch):
    """Five steps from the same params and grads. Both sides see the same
    gradients, so sign(g) is the same and the updates differ by rounding
    only: after every step the params are held at FP32_TOL, and the step
    (p_new - p_old) at rtol 1e-5 plus two float32 spacings of the largest
    weight (the subtraction's rounding); the moments, the norm and lr at
    fp32 tolerances (bf16 moments at one bf16 step). A small update slice
    makes the stacked leaf go through several slices."""
    monkeypatch.setattr(adamw, "UPDATE_SLICE", 50)
    rng = np.random.default_rng(1)
    params = _tree(rng)
    tdt, jdt = getattr(torch, moment_dtype), getattr(jnp, moment_dtype)
    p = convert.params_from_numpy(params, device="cpu")
    state = adamw.init_state(p, moment_dtype=tdt)
    jp = to_jax(params)
    jstate = jadamw.init_state(jp, moment_dtype=jdt)
    cfg, jcfg = adamw.AdamWConfig(**CFG), jadamw.AdamWConfig(**CFG)
    for i in range(5):
        grads = _tree(rng, scale=0.3)
        # copies: the port updates in place
        before = [to_np(t).copy() for t in convert.flatten(p)[0]]
        jbefore = [to_np(t) for t in jax.tree.leaves(jp)]
        p, state, m = adamw.apply_updates(
            cfg, p, convert.params_from_numpy(grads, device="cpu"), state)
        jp, jstate, jm = jadamw.apply_updates(jcfg, jp, to_jax(grads), jstate)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(m["lr"]) == float(jm["lr"])
        assert state["step"].dtype == torch.int32
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        for a, b, a0, b0 in zip(convert.flatten(p)[0], jax.tree.leaves(jp),
                                before, jbefore):
            assert a.dtype == torch.float32
            a, b = to_np(a), to_np(b)
            np.testing.assert_allclose(a, b, err_msg=f"step {i}", **FP32_TOL)
            np.testing.assert_allclose(
                a - a0, b - b0, rtol=1e-5,
                atol=2 * np.spacing(np.abs(b0).max()),
                err_msg=f"step {i}: p_new - p_old")
    tol = (FP32_TOL if moment_dtype == "float32"
           else dict(atol=1e-6, rtol=2 ** -7))
    for name in ("m", "v"):
        for a, b in zip(convert.flatten(state[name])[0],
                        jax.tree.leaves(jstate[name])):
            assert a.dtype == tdt
            np.testing.assert_allclose(to_np(a), to_np(b), err_msg=name,
                                       **tol)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_updates_constant_gradient(moment_dtype):
    """A large lr and the same gradient (|g| >= 0.5, below the clip) at
    every step: then m^ = g and v^ = g^2, so each step moves a 1-D leaf by
    lr * g / (|g| + eps) and a matrix by lr * (that + wd * p), computed
    here in float64. A missing bias correction (0.45 of the first step),
    another lr or eps, or decay on the wrong leaves visibly misses it.
    float32 moments: within 1e-5 of sum(lr); bfloat16 moments round m and
    v by up to 2^-9 each, so the ratio by up to ~2^-8: 4e-3 of sum(lr).
    The port and the reference also agree at FP32_TOL."""
    rng = np.random.default_rng(4)
    params = _tree(rng)
    grads = convert.tree_map(lambda a: np.where(
        rng.random(a.shape) < 0.5, -1, 1) * rng.uniform(0.5, 1.5, a.shape),
        params)
    grads = convert.tree_map(lambda a: a.astype(np.float32), grads)
    cfg_kw = dict(learning_rate=0.1, warmup_steps=2, total_steps=6,
                  grad_clip=1e9)
    cfg, jcfg = adamw.AdamWConfig(**cfg_kw), jadamw.AdamWConfig(**cfg_kw)
    tdt, jdt = getattr(torch, moment_dtype), getattr(jnp, moment_dtype)
    p = convert.params_from_numpy(params, device="cpu")
    state = adamw.init_state(p, moment_dtype=tdt)
    jp = to_jax(params)
    jstate = jadamw.init_state(jp, moment_dtype=jdt)
    want = [a.astype(np.float64) for a in convert.flatten(params)[0]]
    flat_g = [a.astype(np.float64) for a in convert.flatten(grads)[0]]
    lr_sum = 0.0
    for _ in range(5):
        p, state, m = adamw.apply_updates(
            cfg, p, convert.params_from_numpy(grads, device="cpu"), state)
        jp, jstate, _ = jadamw.apply_updates(jcfg, jp, to_jax(grads), jstate)
        lr = float(m["lr"])
        lr_sum += lr
        for i, g in enumerate(flat_g):
            delta = g / (np.abs(g) + cfg.eps)
            if want[i].ndim >= 2:
                delta = delta + cfg.weight_decay * want[i]
            want[i] = want[i] - lr * delta
    atol = (1e-5 if moment_dtype == "float32" else 4e-3) * lr_sum
    for a, b, w in zip(convert.flatten(p)[0], jax.tree.leaves(jp), want):
        np.testing.assert_allclose(to_np(a), w, rtol=0, atol=atol)
        np.testing.assert_allclose(to_np(a), to_np(b), **FP32_TOL)


def test_apply_updates_works_in_place():
    """The params, moments and grads handed in are the tensors updated."""
    rng = np.random.default_rng(2)
    p = convert.params_from_numpy(_tree(rng), device="cpu")
    g = convert.params_from_numpy(_tree(rng, 10.0), device="cpu")
    state = adamw.init_state(p)
    before = [t.clone() for t in convert.flatten(p)[0]]
    new_p, new_state, _ = adamw.apply_updates(adamw.AdamWConfig(**CFG), p, g,
                                              state)
    for a, b, old in zip(convert.flatten(new_p)[0], convert.flatten(p)[0],
                         before):
        assert a is b and not torch.equal(a, old)
    assert new_state["m"] is state["m"]
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1


def test_weight_decay_reaches_matrices_only():
    """A zero gradient moves a matrix by lr * wd * p and leaves a 1-D leaf
    where it was, as in the reference."""
    p = {"w": torch.ones(2, 3), "b": torch.ones(3)}
    g = {"w": torch.zeros(2, 3), "b": torch.zeros(3)}
    cfg = adamw.AdamWConfig(**CFG)
    p, _, m = adamw.apply_updates(cfg, p, g, adamw.init_state(p))
    lr = float(m["lr"])
    np.testing.assert_allclose(to_np(p["w"]), 1 - lr * cfg.weight_decay,
                               rtol=1e-6)
    assert torch.equal(p["b"], torch.ones(3))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_quantize_int8_matches_reference(scale):
    x = (scale * np.random.default_rng(3).standard_normal((64, 33))
         ).astype(np.float32)
    q, s = adamw.quantize_int8(to_torch(x))
    jq, js = jadamw.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(to_np(q), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_allclose(to_np(adamw.dequantize_int8(q, s)),
                               np.asarray(jadamw.dequantize_int8(jq, js)),
                               rtol=1e-7)
    np.testing.assert_allclose(to_np(adamw.dequantize_int8(q, s)), x,
                               atol=float(s) / 2 * 1.0001)


def test_quantize_int8_of_zeros():
    q, s = adamw.quantize_int8(torch.zeros(5))
    jq, js = jadamw.quantize_int8(jnp.zeros(5))
    assert float(s) == float(js) and not torch.any(q)
