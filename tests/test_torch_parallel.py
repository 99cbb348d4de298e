"""The parallel layer against the reference's, in one process: the sharding
rules' specs leaf by leaf for every arch, shape and mesh (the reference's
on a `jax.sharding.AbstractMesh`, the port's on a `MeshShape`), the local
shard shapes of the placements on fake-rank meshes, the activation hints,
`input_specs`, the path strings the rules read, the op counter, one
dry-run cell, the launcher's mesh and a restore onto placements, and the
two reference behaviours the port reproduces on purpose."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.runtime import hints as jhints
from repro.runtime import sharding as jshd
from repro_torch import configs, convert
from repro_torch.checkpoint import store
from repro_torch.data import pipeline
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import MeshShape, make_mesh
from repro_torch.models import blocks, lm
from repro_torch.optim import adamw
from repro_torch.runtime import hints
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps

from test_torch_util import FP32_TOL, random_like, to_jax, to_np, to_torch

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's full-size params as shapes (`jax.eval_shape`), with
    their keystr paths."""
    cfg = jconfigs.get_config(arch)
    tree = jax.eval_shape(lambda: jlm.init_model(cfg, jax.random.PRNGKey(0)))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return tree, [(jax.tree_util.keystr(p), leaf) for p, leaf in flat]


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return lm.init_model(configs.get_config(arch), device="meta")


def _specs(tree_of_shardings):
    return [tuple(s.spec) for s in jax.tree.leaves(tree_of_shardings)]


def _port_specs(tree_of_shardings):
    return [s.spec for s in convert.flatten(tree_of_shardings)[0]]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_paths_are_keystr(arch):
    """`flatten_with_path` gives jax's `keystr` strings for the same tree,
    stacked `scan` tuples and `tail` lists included, in the same order."""
    _, ref = _ref_params(arch)
    mine, _ = convert.flatten_with_path(_port_params(arch))
    assert [p for p, _ in mine] == [p for p, _ in ref]
    assert [tuple(t.shape) for _, t in mine] == [tuple(leaf.shape)
                                                 for _, leaf in ref]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_equal_reference(arch, mesh_name):
    """Param, optimizer-state, batch and cache specs equal `tuple(P)` of the
    reference's, leaf by leaf, for every shape, with `default_parallel`."""
    dims, axes = MESHES[mesh_name]
    jmesh, mesh = AbstractMesh(dims, axes), MeshShape(dims, axes)
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    jparams, _ = _ref_params(arch)
    params = _port_params(arch)
    for name, shape in configs.SHAPES.items():
        jshape = jconfigs.SHAPES[name]
        par, jpar = (configs.default_parallel(cfg, shape),
                     jconfigs.default_parallel(jcfg, jshape))
        assert dataclasses.asdict(par) == dataclasses.asdict(jpar)
        assert _port_specs(shd.params_shardings(cfg, par, mesh, params)) == \
            _specs(jshd.params_shardings(jcfg, jpar, jmesh, jparams))
        o, jo = (shd.opt_state_shardings(cfg, par, mesh, params),
                 jshd.opt_state_shardings(jcfg, jpar, jmesh, jparams))
        for key in ("m", "v"):
            assert _port_specs(o[key]) == _specs(jo[key])
        assert o["step"].spec == tuple(jo["step"].spec) == ()
        b, jb = (shd.batch_shardings(cfg, par, mesh, shape),
                 jshd.batch_shardings(jcfg, jpar, jmesh, jshape))
        assert {k: v.spec for k, v in b.items()} == \
            {k: tuple(v.spec) for k, v in jb.items()}
        if shape.kind != configs.KIND_TRAIN and cfg.is_decoder:
            jcache = jax.eval_shape(lambda: jlm.init_cache(
                jcfg, jshape.global_batch, jshape.seq_len))
            cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  device="meta")
            assert _port_specs(shd.cache_shardings(cfg, par, mesh, cache)) \
                == _specs(jshd.cache_shardings(jcfg, jpar, jmesh, jcache))


@pytest.fixture
def fake_16x16():
    with dryrun.fake_world(256):
        yield make_mesh((16, 16), ("data", "model"), "cpu")


@pytest.fixture
def fake_2x16x16():
    with dryrun.fake_world(512):
        yield make_mesh((2, 16, 16), ("pod", "data", "model"), "cpu")


def _local_shapes_match(arch, mesh):
    """Every param's local shard on `mesh` (a meta DTensor) has the shape
    the reference's `NamedSharding.shard_shape` gives on the same mesh."""
    from torch.distributed.tensor import distribute_tensor
    dims, axes = tuple(mesh.shape), tuple(mesh.mesh_dim_names)
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    shape = configs.TRAIN_4K
    par = configs.default_parallel(cfg, shape)
    jmesh = AbstractMesh(dims, axes)
    jparams, _ = _ref_params(arch)
    jsh = jax.tree.leaves(jshd.opt_state_shardings(
        jcfg, jconfigs.default_parallel(jcfg, jconfigs.TRAIN_4K), jmesh,
        jparams)["m"])
    params = _port_params(arch)
    sh = convert.flatten(shd.opt_state_shardings(cfg, par, mesh,
                                                 params)["m"])[0]
    leaves = convert.flatten(params)[0]
    assert len(sh) == len(jsh) == len(leaves)
    for t, s, js in zip(leaves, sh, jsh):
        local = distribute_tensor(t, mesh, s.placements,
                                  src_data_rank=None).to_local()
        want = NamedSharding(jmesh, js.spec).shard_shape(tuple(t.shape))
        assert tuple(local.shape) == tuple(want) == s.shard_shape(t.shape)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_placements_give_the_references_shard_shapes_16x16(fake_16x16,
                                                           arch):
    _local_shapes_match(arch, fake_16x16)


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "kimi-k2-1t-a32b"])
def test_placements_give_the_references_shard_shapes_2x16x16(fake_2x16x16,
                                                             arch):
    """("pod", "data") on one dim: pod-major, as jax orders it."""
    _local_shapes_match(arch, fake_2x16x16)


@pytest.mark.parametrize("rank", range(8))
def test_a_pod_data_entry_is_pod_major_as_in_jax(rank):
    """("pod", "data") on one dim cuts it pod-major, as jax orders a tuple
    entry: every rank of a (2, 2, 2) mesh holds the slice that the device
    at its mesh position holds in the reference."""
    from jax.sharding import Mesh, PartitionSpec as P
    from torch.distributed.tensor import distribute_tensor
    axes = ("pod", "data", "model")
    spec = (("pod", "data"), "model")
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), axes)
    index = NamedSharding(jmesh, P(*spec)).devices_indices_map((8, 4))
    want = index[jmesh.devices[rank // 4, (rank // 2) % 2, rank % 2]]
    with dryrun.fake_world(8, rank):
        mesh = make_mesh((2, 2, 2), axes, "cpu")
        t = distribute_tensor(torch.empty(8, 4, device="meta"), mesh,
                              shd.to_placements(spec, mesh),
                              src_data_rank=None)
        shape, offset = hints.local_box(t)
    assert [(o, o + n) for o, n in zip(offset, shape)] == \
        [(sl.start or 0, sl.stop or dim) for sl, dim in zip(want, (8, 4))]


def test_to_placements_refuses_an_axis_order_against_the_mesh():
    mesh = MeshShape((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="axis order"):
        shd.to_placements((("data", "pod"), None), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        shd.to_placements(("model", "model"), mesh)


# ------------------------------------------------------------------ hints
def test_constrain_is_the_identity_without_axes():
    hints.set_mesh_axes(None)
    x = torch.ones(4, 6)
    assert hints.constrain(x, "data", "model") is x
    assert hints.whole_groups(x, -1, 5) is x
    assert hints.axis_size("model") == 1
    assert hints.batch_spec_axes() == ("data",)


SPECS = [
    ((256, 4096, 16, 128), (("data",), None, "model", None)),
    ((256, 4096, 28, 128), ("data", None, "model", None)),   # 28 % 16: dropped
    ((8, 4096, 2048), ("data", "model", None)),              # 8 % 16: dropped
    ((256, 4096, 2048), (("pod", "data"), None, "model")),   # no pod: dropped
    ((512, 64), ("model", None)),
]


@pytest.mark.parametrize("shape,spec", SPECS)
def test_constrain_gives_the_references_cleaned_spec(fake_16x16, monkeypatch,
                                                     shape, spec):
    """On a fake 16x16 mesh a DTensor is laid out as the reference's
    `with_sharding_constraint` is asked to lay it out, entries that do not
    divide or name no axis of the mesh dropped to None."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    asked = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, p: asked.append(tuple(p)) or x)
    jhints.set_mesh_axes({"data": 16, "model": 16})
    try:
        jhints.constrain(jax.ShapeDtypeStruct(shape, jnp.float32), *spec)
    finally:
        jhints.set_mesh_axes(None)
    hints.set_mesh(fake_16x16)
    try:
        x = distribute_tensor(torch.empty(shape, device="meta"), fake_16x16,
                              [Replicate(), Replicate()])
        y = hints.constrain(x, *spec)
    finally:
        hints.set_mesh_axes(None)
    want = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in asked[0])
    assert tuple(y.placements) == shd.to_placements(want, fake_16x16)
    assert tuple(y.to_local().shape) == shd.Sharding(
        fake_16x16, want).shard_shape(shape)


def test_whole_groups_gathers_a_dim_split_inside_a_head(fake_16x16):
    """28 heads of 128 over 16 ranks: a shard would hold 1.75 heads, so the
    dim is gathered before the split; 16 heads stay sharded."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = distribute_tensor(torch.empty(4, 8, 28 * 128, device="meta"),
                          fake_16x16, [Replicate(), Shard(2)])
    assert tuple(hints.whole_groups(x, -1, 28).placements) == (
        Replicate(), Replicate())
    assert hints.whole_groups(x, -1, 16) is x


# ----------------------------------------------------------- input specs
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_equal_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        mine = pipeline.input_specs(cfg, shape)
        theirs = jpipeline.input_specs(jcfg, jconfigs.SHAPES[name])
        assert set(mine) == set(theirs), name
        for k, t in mine.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(theirs[k].shape), (name, k)
            assert str(t.dtype).split(".")[1] == str(theirs[k].dtype) or (
                t.dtype == torch.bfloat16 and theirs[k].dtype == jnp.bfloat16)


def test_input_specs_attach_placements(fake_16x16):
    cfg = configs.get_config("qwen2-vl-2b")
    shape = configs.TRAIN_4K
    b_sh = shd.batch_shardings(cfg, configs.default_parallel(cfg, shape),
                               fake_16x16, shape)
    specs = pipeline.input_specs(
        cfg, shape, sharding_fn=lambda n: b_sh["tokens"]
        if n == "tokens" else None)
    assert tuple(specs["tokens"].to_local().shape) == (256 // 16, 4096)
    assert not hasattr(specs["vision_embeds"], "placements")


# -------------------------------------------------------------- op counts
def test_op_counter_counts_a_product():
    a, b = torch.randn(32, 128), torch.randn(128, 16)
    with op_analysis.OpCounter() as c:
        a @ b
    assert c.counts.flops == 2 * 32 * 128 * 16
    assert c.counts.hbm_bytes == (32 * 128 + 128 * 16 + 32 * 16) * 4


def test_op_counter_counts_per_device_on_a_fake_mesh(fake_16x16):
    """A product sharded over both axes of a 16x16 mesh counts 1/256 of its
    global FLOPs on rank 0 (FlopCounterMode would count all of them)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(256, 512, 2048), fake_16x16,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(2048, 11008), fake_16x16,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with op_analysis.OpCounter() as c:
            y = x @ w
    assert tuple(y.to_local().shape) == (16, 512, 688)
    assert c.counts.flops == 2 * 256 * 512 * 2048 * 11008 / 256
    assert c.counts.ici_bytes == 0


def test_op_counter_counts_collective_payloads(fake_16x16):
    """An all-gather's payload is its result; an all-reduce's is twice it
    (ring reduce-scatter + all-gather), as `_COLLECTIVE_FACTOR` has it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor import DTensor
    with FakeTensorMode():
        local = torch.empty(16, 64)
        sharded = DTensor.from_local(local, fake_16x16, [Replicate(),
                                                         Shard(0)])
        partial = DTensor.from_local(local, fake_16x16, [Replicate(),
                                                         Partial()])
        with op_analysis.OpCounter() as c:
            sharded.redistribute(fake_16x16, [Replicate(), Replicate()])
            partial.redistribute(fake_16x16, [Replicate(), Replicate()])
    gathered = 16 * 16 * 64 * 4
    assert c.counts.by_collective == {"all_gather_into_tensor": gathered,
                                      "all_reduce": 2 * 16 * 64 * 4}
    assert c.counts.collective_count == 2


# ---------------------------------------------------------------- dry run
def test_dryrun_cell_on_a_fake_debug_mesh():
    """The counterpart of the reference's slow `test_dryrun_cell_on_debug_
    mesh`, fast here because the ranks and tensors are fake: granite at
    decode_32k on a (4, 2) mesh, with the reference's keys where they mean
    the same, finite terms, and the argument bytes those of the local
    shards."""
    res = dryrun.run_cell("granite-moe-1b-a400m", "decode_32k", False,
                          mesh_shape=((4, 2), ("data", "model")))
    assert not res["skipped"] and res["chips"] == 8
    for key in ("flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev",
                "collectives", "model_flops_total", "useful_flops_ratio",
                "bottleneck", "roofline_frac"):
        assert key in res
    assert set(res["terms"]) == {"compute_s", "memory_s", "collective_s"}
    assert all(np.isfinite(v) and v >= 0 for v in res["terms"].values())
    assert res["flops_per_dev"] > 0 and 0 < res["useful_flops_ratio"]
    want = dryrun.argument_bytes("granite-moe-1b-a400m", "decode_32k",
                                 MeshShape((4, 2), ("data", "model")))
    cfg = configs.get_config("granite-moe-1b-a400m")
    params = lm.init_model(cfg, device="meta")
    cache = lm.init_cache(cfg, 128, 32768, device="meta")
    whole = sum(t.numel() * t.element_size() for t in
                convert.flatten(params)[0] + convert.flatten(cache)[0])
    assert res["mem"]["argument_gb"] == want / 1e9
    assert want < whole                 # the specs do shard the state


def test_dryrun_extrapolation_equals_the_whole_step():
    """Counts from 1 and 2 periods are those of every period: the
    extrapolated cell equals the full-depth run."""
    kw = dict(mesh_shape=((4, 2), ("data", "model")))
    cut = dryrun.run_cell("qwen2.5-3b", "decode_32k", False, **kw)
    whole = dryrun.run_cell("qwen2.5-3b", "decode_32k", False,
                            full_depth=True, **kw)
    assert cut["depth_runs"] == [[1, 1], [2, 1]]
    assert whole["depth_runs"] == [[36, 1]]
    for key in ("flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev",
                "op_count"):
        assert cut[key] == pytest.approx(whole[key], rel=1e-9), key


# ---------------------------------------------------------------- launcher
def test_launch_train_at_world_size_one_matches_the_unsharded_step(tmp_path):
    """`--device cpu` at world size 1 builds a (1, 1) mesh, on which every
    placement is Replicate: two smoke steps end where the unsharded
    `make_train_step` ends."""
    res = train_mod.train("qwen2.5-3b", smoke=True, steps=2, batch=2,
                          seq=16, checkpoint_every=100, device="cpu",
                          checkpoint_dir=str(tmp_path / "ck"))
    assert not dist.is_initialized()
    cfg = configs.get_smoke_config("qwen2.5-3b")
    params = lm.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    opt = adamw.init_state(params)
    step = steps.make_train_step(cfg, configs.ParallelConfig(remat="full"),
                                 adamw.AdamWConfig(total_steps=2))
    shape = configs.ShapeConfig("cli_train", 16, 2, configs.KIND_TRAIN)
    for i in range(2):
        params, opt, m = step(params, opt, pipeline.batch_to(
            pipeline.synthetic_batch(cfg, shape, i), "cpu"))
        assert res["history"][i]["loss"] == float(m["loss"])
        assert res["history"][i]["grad_norm"] == float(m["grad_norm"])
    for a, b in zip(convert.flatten(res["state"]["params"])[0],
                    convert.flatten(params)[0]):
        assert torch.equal(a, b)


def test_restore_lands_on_the_placements(tmp_path):
    """`restore(sharding_fn=)` gives each leaf as a DTensor on the placements
    it returns, whatever layout wrote it."""
    from torch.distributed.tensor import DTensor, Shard
    cfg = configs.get_smoke_config("qwen2.5-3b")
    params = lm.init_model(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    ck = store.CheckpointStore(str(tmp_path / "ck"))
    ck.save(3, {"params": params}, blocking=True)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "pg"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        p_sh = shd.params_shardings(cfg, configs.ParallelConfig(), mesh,
                                    params)
        lookup = dict(convert.flatten_with_path({"params": p_sh})[0])
        got, _ = ck.restore(3, {"params": params},
                            sharding_fn=lambda key, leaf: lookup[key])
        for t, want, s in zip(convert.flatten(got)[0],
                              convert.flatten(params)[0],
                              convert.flatten(p_sh)[0]):
            assert isinstance(t, DTensor)
            assert tuple(t.placements) == s.placements
            assert torch.equal(t.full_tensor(), want)
        assert any(isinstance(pl, Shard) for s in convert.flatten(p_sh)[0]
                   for pl in s.placements)
    finally:
        dist.destroy_process_group()


def test_sharded_step_on_one_rank_is_bit_equal_to_the_plain_step(tmp_path):
    """The sharded step (`jit_train_step`, DTensors on a one-rank gloo (1, 1)
    mesh) and `make_train_step` from the same weights and batches, qwen2.5-3b
    smoke, B4 S32, 2 microbatches, 3 steps: the same losses, grad norms and
    params to the last bit. A guard on the sharded step's op order: both
    paths must take the same ops (the embedding through `hints.take_rows`),
    which on the H100 parted by 1.35e-5 when they did not (ROADMAP Queue C);
    FP32_TOL, which the multi-rank tests hold, would let that through."""
    cfg = configs.get_smoke_config("qwen2.5-3b")
    par = configs.ParallelConfig(remat="full", microbatches=2)
    shape = configs.ShapeConfig("t", 32, 4, configs.KIND_TRAIN)
    opt_cfg = adamw.AdamWConfig(total_steps=3)
    batches = [pipeline.batch_to(pipeline.synthetic_batch(cfg, shape, i),
                                 "cpu") for i in range(3)]

    def fresh():
        params = lm.init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        return params, adamw.init_state(params)

    params, opt = fresh()
    step = steps.make_train_step(cfg, par, opt_cfg)
    plain = []
    for batch in batches:
        params, opt, m = step(params, opt, batch)
        plain.append((float(m["loss"]), float(m["grad_norm"])))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "pg"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        sparams, sopt = fresh()
        sstep, p_sh, o_sh, _ = steps.jit_train_step(cfg, par, mesh, opt_cfg,
                                                    sparams, sopt, shape)
        sparams = steps.place_tree(sparams, p_sh)
        sopt = steps.place_tree(sopt, o_sh)
        sharded = []
        for batch in batches:
            sparams, sopt, m = sstep(sparams, sopt, batch)
            sharded.append((float(m["loss"]), float(m["grad_norm"])))
        sleaves = [t.full_tensor() for t in convert.flatten(sparams)[0]]
    finally:
        dist.destroy_process_group()
    assert sharded == plain
    for a, b in zip(sleaves, convert.flatten(params)[0]):
        assert torch.equal(a, b)


# ------------------------------------------- reference quirks, reproduced
@pytest.mark.parametrize("branch", ["flash", "chunked"])
def test_pad_heads_breaks_the_fast_branches_in_both_packages(monkeypatch,
                                                             branch):
    """Reproduced on purpose: with `pad_heads` on a "model" axis of 2, 3
    query heads on 1 KV head are padded to 4, and only the plain branch
    strips the padding. The flash branch (kernels, S >= 128) and the
    chunked branch (S >= chunk_threshold) reach `wo` with 4 heads and fail
    on its shape, in the reference and in the port."""
    S = 128
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen2.5-3b"),
                               num_heads=3, num_kv_heads=1)
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2.5-3b"),
                              num_heads=3, num_kv_heads=1)
    jp = jax.tree.map(lambda a: a[0], jlm.init_model(
        jcfg, jax.random.PRNGKey(0))["scan"][0]["mix"])
    p = random_like(jax.tree.map(np.asarray, jp), np.random.default_rng(0))
    x = np.random.default_rng(1).standard_normal(
        (1, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (1, S))
    use_kernels = branch == "flash"
    for mod in (blocks, jblocks):
        monkeypatch.setitem(mod.ATTN_CONFIG, "pad_heads", 1)
        if branch == "chunked":
            monkeypatch.setitem(mod.ATTN_CONFIG, "chunk_threshold", S)
    jhints.set_mesh_axes({"data": 1, "model": 2})
    try:
        with pytest.raises(TypeError, match="dot_general"):
            jblocks.attention(jcfg, to_jax(p), jnp.asarray(x),
                              jnp.asarray(pos), use_kernels=use_kernels)
    finally:
        jhints.set_mesh_axes(None)
    hints.set_mesh_axes({"data": 1, "model": 2})
    try:
        with pytest.raises(RuntimeError, match="cannot be multiplied"):
            blocks.attention(cfg, convert.params_from_numpy(p, device="cpu"),
                             to_torch(x), torch.from_numpy(pos.copy()),
                             use_kernels=use_kernels)
    finally:
        hints.set_mesh_axes(None)
    # the plain branch strips the padding: the two packages agree
    for mod in (blocks, jblocks):
        monkeypatch.setitem(mod.ATTN_CONFIG, "chunk_threshold", 8192)
    jhints.set_mesh_axes({"data": 1, "model": 2})
    hints.set_mesh_axes({"data": 1, "model": 2})
    try:
        jout, _ = jblocks.attention(jcfg, to_jax(p), jnp.asarray(x),
                                    jnp.asarray(pos))
        out, _ = blocks.attention(
            cfg, convert.params_from_numpy(p, device="cpu"), to_torch(x),
            torch.from_numpy(pos.copy()))
    finally:
        jhints.set_mesh_axes(None)
        hints.set_mesh_axes(None)
    np.testing.assert_allclose(to_np(out), to_np(jout), **FP32_TOL)
