"""The sharded train step, expert-parallel MoE and the cross-pod mean across
real processes: `gloo` ranks on the CPU, each a `tests/torch_parallel_worker.py`
process joined through a `FileStore` in the test's own directory, under a
hard deadline that kills them all and fails.

The same numpy weights and batches go through the port's sharded step on a
(2, 2) ("data", "model") mesh of 4 ranks, the port's unsharded
`make_train_step`, and the reference's `jit_train_step` on a (2, 2) mesh of
4 of its 8 fake CPU devices, all in fp32 compute."""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import rwkv6 as jrwkv6
from repro.optim import adamw as jadamw
from repro.runtime import hints as jhints
from repro.runtime import steps as jsteps
from repro_torch import configs, convert
from repro_torch.models import blocks
from repro_torch.optim import adamw
from repro_torch.runtime import steps

from test_torch_util import (FP32_TOL, assert_steps_close,
                             jax_tree_to_numpy, random_like, to_jax, to_np)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")
DEADLINE_S = 120
S, BATCH, STEPS = 32, 4, 3


def run_ranks(job, world, workdir, inp, deadline=DEADLINE_S):
    """Run `job` on `world` worker processes -> their outputs by rank. A
    rank that fails, or a group that outlives `deadline`, kills them all
    and fails the test."""
    workdir = str(workdir)
    with open(os.path.join(workdir, "input.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, job, str(r), str(world), workdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=deadline)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{job}: {world} ranks outlived the {deadline} s deadline")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {job} failed:\n{log[-4000:]}"
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _ref_mesh(shape=(2, 2), axes=("data", "model")):
    """A mesh of the first prod(shape) fake CPU devices, its axes Auto as
    the reference's `launch/mesh.py` makes them."""
    n = int(np.prod(shape))
    return jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


@functools.lru_cache(maxsize=None)
def _weights(arch, replace=()):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **dict(replace))
    shapes = jax_tree_to_numpy(jlm.init_model(jcfg, jax.random.PRNGKey(0)))
    return random_like(shapes, np.random.default_rng(0))


def _batches(cfg):
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(10 + i)
        out.append({k: rng.integers(0, cfg.vocab_size, (BATCH, S),
                                    dtype=np.int32)
                    for k in ("tokens", "labels")})
    return out


def _reference_steps(monkeypatch, arch, replace, knobs, params, batches):
    """The reference's `jit_train_step` on its (2, 2) mesh -> (metrics,
    params leaves, lr sum)."""
    monkeypatch.setattr(jlm, "train_loss", functools.partial(
        jlm.train_loss, dtype=jnp.float32))
    for key, val in knobs.items():
        group, field = key.split(".")
        target = {"attn": jblocks.ATTN_CONFIG, "moe": jmoe.MOE_CONFIG,
                  "rwkv": jrwkv6.RWKV_CONFIG}[group]
        monkeypatch.setitem(target, field, val)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **replace)
    jpar = jconfigs.ParallelConfig(remat="full")
    mesh = _ref_mesh()
    jhints.set_mesh(mesh)
    try:
        with mesh:
            jp = to_jax(params)
            jo = jadamw.init_state(jp)
            step, p_sh, o_sh, _ = jsteps.jit_train_step(
                jcfg, jpar, mesh, jadamw.AdamWConfig(total_steps=STEPS), jp,
                jo, jconfigs.ShapeConfig("t", S, BATCH, "train"))
            jp, jo = jax.device_put(jp, p_sh), jax.device_put(jo, o_sh)
            metrics = []
            for b in batches:
                jp, jo, m = step(jp, jo, to_jax(b))
                metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jhints.set_mesh_axes(None)
    return metrics, [to_np(t) for t in jax.tree.leaves(jp)]


def _unsharded_port(arch, replace, params, batches):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **replace)
    step = steps.make_train_step(cfg, configs.ParallelConfig(remat="full"),
                                 adamw.AdamWConfig(total_steps=STEPS),
                                 dtype=torch.float32)
    p = convert.params_from_numpy(params, device="cpu")
    o = adamw.init_state(p)
    metrics = []
    for b in batches:
        p, o, m = step(p, o, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [to_np(t) for t in convert.flatten(p)[0]]


def _sharded(tmp_path, arch, replace, knobs, params, batches):
    return run_ranks("train_step", 4, tmp_path, {
        "arch": arch, "replace": replace, "knobs": knobs, "params": params,
        "batches": batches, "seq": S, "batch": BATCH, "mesh": (2, 2),
        "axes": ("data", "model")})


CASES = {
    "dense": ("qwen2.5-3b", {}, {}),
    # 3 query heads on 1 KV head: 3 does not divide the "model" axis of 2,
    # so `pad_heads` pads each group to 4 heads (the plain path, S < 128)
    "pad_heads": ("qwen2.5-3b", {"num_heads": 3, "num_kv_heads": 1},
                  {"attn.pad_heads": 1}),
    "moe_sharded": ("granite-moe-1b-a400m", {}, {"moe.sharded": 1}),
    # global capacity on DTensors: every rank routes all tokens, runs its
    # "model" shard's experts (`moe._capacity_sharded`)
    "moe_capacity": ("granite-moe-1b-a400m", {}, {}),
    # the mixers on local (batch, head) / width blocks
    "rwkv6_chunked": ("rwkv6-7b", {}, {"rwkv.impl": "chunked"}),
    "recurrentgemma": ("recurrentgemma-9b", {}, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_train_step_matches_reference(tmp_path, monkeypatch, case):
    """Three steps on 4 gloo ranks: loss, grad norm and lr of every step
    within FP32_TOL of the reference's `jit_train_step` on the same mesh,
    the params held by `assert_steps_close` (the first Adam step is
    sign-sensitive where a gradient is near its rounding, as in
    `test_torch_train_step.py`); every rank reports the same metrics, and
    at least one param leaf is split over more than one rank."""
    arch, replace, knobs = CASES[case]
    params = _weights(arch, tuple(sorted(replace.items())))
    cfg = configs.get_smoke_config(arch)
    batches = _batches(cfg)
    outs = _sharded(tmp_path, arch, replace, knobs, params, batches)
    jm, jp = _reference_steps(monkeypatch, arch, replace, knobs, params,
                              batches)
    for r in range(1, 4):
        if case == "moe_sharded":
            # each data shard's loss carries its own tokens' aux (the
            # reference's unchecked-replicated aux, of which it reads device
            # 0's); the gradients, and so the norm and the update, are summed
            same = {k: v for k, v in outs[r]["metrics"][-1].items()
                    if k in ("grad_norm", "lr")}
            assert same == {k: outs[0]["metrics"][-1][k] for k in same}, r
        else:
            assert outs[r]["metrics"] == outs[0]["metrics"], r
    assert outs[0]["step"] == STEPS
    assert max(outs[0]["shards"]) > 1, outs[0]["shards"]
    for i, (m, want) in enumerate(zip(outs[0]["metrics"], jm)):
        assert set(m) == set(want), i
        for key in want:
            np.testing.assert_allclose(m[key], want[key],
                                       err_msg=f"{case} step {i} {key}",
                                       **FP32_TOL)
    lr_sum = sum(m["lr"] for m in jm)
    assert_steps_close(outs[0]["params"], jp, lr_sum, case)


@pytest.mark.parametrize("case", ["dense", "pad_heads", "moe_capacity",
                                  "rwkv6_chunked", "recurrentgemma"])
def test_sharded_train_step_matches_unsharded_port(tmp_path, monkeypatch,
                                                   case):
    """The same steps through the port's unsharded `make_train_step`:
    metrics and the gathered params within FP32_TOL (the sharded step sums
    the same products in another grouping)."""
    from repro_torch.models import rwkv6
    arch, replace, knobs = CASES[case]
    params = _weights(arch, tuple(sorted(replace.items())))
    batches = _batches(configs.get_smoke_config(arch))
    outs = _sharded(tmp_path, arch, replace, knobs, params, batches)
    for key, val in knobs.items():
        group, field = key.split(".")
        monkeypatch.setitem({"attn": blocks.ATTN_CONFIG,
                             "rwkv": rwkv6.RWKV_CONFIG}[group], field, val)
    um, up = _unsharded_port(arch, replace, params, batches)
    for i, (m, want) in enumerate(zip(outs[0]["metrics"], um)):
        for key in want:
            np.testing.assert_allclose(m[key], want[key],
                                       err_msg=f"{case} step {i} {key}",
                                       **FP32_TOL)
    for a, b in zip(outs[0]["params"], up):
        np.testing.assert_allclose(a, b, **FP32_TOL)


def test_moe_sharded_matches_reference(tmp_path):
    """`apply_moe_sharded` on granite's smoke FFN over a (2, 2) mesh: the
    output within FP32_TOL of the reference's `shard_map` on its own (2, 2)
    mesh, and rank 0's aux (data shard 0's tokens) equal to the aux the
    reference returns, which is its device 0's."""
    arch = "granite-moe-1b-a400m"
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    ffn = jax.tree.map(lambda a: a[0], _weights(arch)["scan"][0]["ffn"])
    x = np.random.default_rng(3).standard_normal(
        (4, 8, cfg.d_model)).astype(np.float32)
    outs = run_ranks("moe", 4, tmp_path, {
        "arch": arch, "ffn": ffn, "x": x, "mesh": (2, 2),
        "axes": ("data", "model")})
    mesh = _ref_mesh()
    jhints.set_mesh(mesh)
    try:
        with mesh:
            jout, jaux = jmoe.apply_moe_sharded(jcfg, to_jax(ffn),
                                                jnp.asarray(x))
    finally:
        jhints.set_mesh_axes(None)
    for r in range(4):
        np.testing.assert_allclose(outs[r]["out"], to_np(jout), **FP32_TOL)
    np.testing.assert_allclose(outs[0]["aux"], float(jaux), **FP32_TOL)
    # the other data shard's aux is its own tokens', as the reference's
    # local function computes it there
    assert outs[1]["aux"] == outs[0]["aux"]
    assert outs[2]["aux"] == outs[3]["aux"]


def test_compressed_cross_pod_mean_matches_reference(tmp_path):
    """Two gloo ranks as "pod" against the reference under `shard_map`
    over a 2-device ("pod",) mesh: each rank's mean and residual. The pods'
    grads differ in scale, so the reference's quirk shows: the summed int8
    payload is dequantized with the LOCAL scale, and the two pods' "means"
    differ, in both packages."""
    from jax.sharding import PartitionSpec as P
    rng = np.random.default_rng(5)
    grads = [{"a": (rng.standard_normal((6, 5)) * s).astype(np.float32),
              "b": (rng.standard_normal((7,)) * s).astype(np.float32)}
             for s in (1.0, 3.0)]
    error = [{"a": (0.01 * rng.standard_normal((6, 5))).astype(np.float32),
              "b": (0.01 * rng.standard_normal((7,))).astype(np.float32)}
             for _ in range(2)]
    outs = run_ranks("cross_pod", 2, tmp_path, {
        "grads": grads, "error": error, "mesh": (2,), "axes": ("pod",)})
    mesh = _ref_mesh((2,), ("pod",))
    stack = lambda trees: jax.tree.map(  # noqa: E731
        lambda *a: jnp.stack(a), *trees)
    fn = jax.shard_map(
        lambda g, e: jax.tree.map(
            lambda t: t[None], jadamw.compressed_cross_pod_mean(
                jax.tree.map(lambda t: t[0], g), "pod",
                jax.tree.map(lambda t: t[0], e))),
        mesh=mesh, in_specs=(P("pod"), P("pod")), out_specs=P("pod"))
    jmean, jerr = fn(stack(grads), stack(error))
    for r in range(2):
        for k in ("a", "b"):
            np.testing.assert_allclose(outs[r]["mean"][k],
                                       to_np(jmean[k])[r], **FP32_TOL)
            np.testing.assert_allclose(outs[r]["error"][k],
                                       to_np(jerr[k])[r], **FP32_TOL)
    # the quirk: the two pods do not agree on the mean
    assert not np.allclose(outs[0]["mean"]["a"], outs[1]["mean"]["a"])


CHUNKED = {"attn.chunk_threshold": 8, "attn.q_chunk": 4, "attn.kv_chunk": 4}


@pytest.mark.parametrize("arch,replace,knobs", [
    ("qwen2.5-3b", {}, {}),                       # heads over "model"
    ("qwen2.5-3b", {"num_kv_heads": 1}, {}),      # 1 KV head: T over "model"
    ("recurrentgemma-9b", {}, {}),                # the window's ring cache
    # the chunked prefill, on (batch, head) blocks and, with 3 heads on a
    # "model" axis of 2, on (batch, query) blocks
    ("qwen2.5-3b", {}, CHUNKED),
    ("qwen2.5-3b", {"num_heads": 3, "num_kv_heads": 1}, CHUNKED),
])
def test_sharded_decode_matches_plain(tmp_path, monkeypatch, arch, replace,
                                      knobs):
    """Prefill and decode steps on DTensor params and a DTensor cache (4
    gloo ranks, the cache rules' placements: batch over "data", heads or
    positions over "model") fill and write the same rows and give the
    logits of the plain path, within FP32_TOL (fp32 compute and cache on
    both sides)."""
    from repro_torch.models import lm
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **replace)
    params = _weights(arch, tuple(sorted(replace.items())))
    for key, val in knobs.items():
        monkeypatch.setitem(blocks.ATTN_CONFIG, key.split(".")[1], val)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (4, 8), dtype=np.int32)
    tokens = [rng.integers(0, cfg.vocab_size, (4, 1), dtype=np.int32)
              for _ in range(3)]
    outs = run_ranks("decode", 4, tmp_path, {
        "arch": arch, "replace": replace, "knobs": knobs, "params": params,
        "batch": 4,
        "max_len": 16, "prompt": prompt, "tokens": tokens, "mesh": (2, 2),
        "axes": ("data", "model")})
    p = convert.params_from_numpy(params, device="cpu")
    cache = lm.init_cache(cfg, 4, 16, dtype=torch.float32, device="cpu")
    out, cache = lm.prefill(cfg, p, {"tokens": torch.from_numpy(prompt)},
                            cache, dtype=torch.float32)
    want = [to_np(out)]
    for tok in tokens:
        out, cache = lm.decode_step(cfg, p, torch.from_numpy(tok), cache,
                                    dtype=torch.float32)
        want.append(to_np(out))
    for i, w in enumerate(want):
        for r in range(4):
            np.testing.assert_allclose(outs[r]["logits"][i], w,
                                       err_msg=f"step {i} rank {r}",
                                       **FP32_TOL)
    for a, b in zip(outs[0]["cache"], convert.flatten(cache)[0]):
        np.testing.assert_allclose(a, to_np(b), **FP32_TOL)
    assert any("Shard" in pl for pl in outs[0]["placements"])
