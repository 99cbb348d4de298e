"""The training substrates of the port against the reference's: the
synthetic batches, the prefetching loader, checkpoints written by either
package and read by the other (byte for byte), pruning, the supervisor's
failure replay and its restart quirk, the step monitor, and the
`repro_torch.launch.train` entry point on the CPU."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import store as jstore
from repro.data import pipeline as jpipeline
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime import ft as jft
from repro_torch import configs, convert
from repro_torch.checkpoint import store
from repro_torch.data import pipeline
from repro_torch.launch import train as train_mod
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import ft, steps

from test_torch_util import jax_tree_to_numpy, random_like, to_jax


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_synthetic_batch_equals_reference(arch, kind):
    shape = configs.ShapeConfig("t", 24, 3, kind)
    jshape = jconfigs.ShapeConfig("t", 24, 3, kind)
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for step, seed in ((0, 0), (7, 0), (7, 3)):
        got = pipeline.synthetic_batch(cfg, shape, step, seed)
        want = jpipeline.synthetic_batch(jcfg, jshape, step, seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    got = pipeline.synthetic_batch(cfg, shape, 1, batch_override=5)
    want = jpipeline.synthetic_batch(jcfg, jshape, 1, batch_override=5)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetching_loader_order_and_shutdown(device):
    """Batches come in step order from `start_step`, equal to
    `synthetic_batch` of their step (numpy without a device, tensors on
    the CPU); `close` stops the producer."""
    cfg = configs.get_smoke_config("qwen2-vl-2b")
    shape = configs.ShapeConfig("t", 16, 2, configs.KIND_TRAIN)
    loader = pipeline.PrefetchingLoader(cfg, shape, seed=5, depth=2,
                                        start_step=3, device=device)
    try:
        for want_step, (step, batch) in zip(range(3, 8), loader):
            assert step == want_step
            want = pipeline.synthetic_batch(cfg, shape, step, 5)
            assert sorted(batch) == sorted(want)
            for k, v in batch.items():
                if device is None:
                    assert isinstance(v, np.ndarray)
                else:
                    assert isinstance(v, torch.Tensor)
                    assert v.device.type == "cpu"
                np.testing.assert_array_equal(np.asarray(v), want[k])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


# ------------------------------------------------------------ checkpoints
def _smoke_state(moment_dtype):
    """A reference train state after one AdamW step (so the moments are
    not zeros), as JAX arrays, and the same as the port's tensors."""
    jcfg = jconfigs.get_smoke_config("qwen2.5-3b")
    shapes = jax_tree_to_numpy(jlm.init_model(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    jparams = to_jax(random_like(shapes, rng))
    grads = to_jax(random_like(shapes, rng))
    jopt = jadamw.init_state(jparams, moment_dtype=getattr(jnp, moment_dtype))
    jparams, jopt, _ = jadamw.apply_updates(jadamw.AdamWConfig(), jparams,
                                            grads, jopt)
    jtree = {"params": jparams, "opt_state": jopt}
    tree = convert.cache_from_numpy(jax_tree_to_numpy(jtree), device="cpu")
    return jtree, tree


def _files(d):
    return sorted(os.listdir(d))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_checkpoint_is_byte_identical_and_restores_across_packages(
        tmp_path, moment_dtype):
    jtree, tree = _smoke_state(moment_dtype)
    a, b = tmp_path / "ref", tmp_path / "port"
    jstore.CheckpointStore(str(a)).save(5, jtree, blocking=True,
                                        extra={"step": 5})
    s = store.CheckpointStore(str(b))
    s.save(5, tree, extra={"step": 5})              # written on a thread
    s.wait()
    da, db = a / "step_00000005", b / "step_00000005"
    assert _files(da) == _files(db)
    ma = json.loads((da / "manifest.json").read_text())
    mb = json.loads((db / "manifest.json").read_text())
    assert ma == mb
    assert (da / "manifest.json").read_bytes() == \
        (db / "manifest.json").read_bytes()
    assert "['opt_state']['step']" in [r["path"] for r in ma["leaves"]]
    assert "['params']['scan'][0]['mix']['wq']" in [
        r["path"] for r in ma["leaves"]]
    want_dtypes = {"float32", "int32"} | {moment_dtype}
    assert {r["dtype"] for r in ma["leaves"]} == want_dtypes
    for name in _files(da):
        assert (da / name).read_bytes() == (db / name).read_bytes(), name

    # the reference's checkpoint restores in the port, bit for bit
    restored, extra = store.CheckpointStore(str(a)).restore(5, tree)
    assert extra == {"step": 5}
    for got, want in zip(convert.flatten(restored)[0],
                         convert.flatten(tree)[0]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    # and the port's in the reference (which loads bfloat16 as its raw
    # 16 bits, `|V2`, from its own checkpoints too)
    jrestored, jextra = jstore.CheckpointStore(str(b)).restore(5, jtree)
    assert jextra == {"step": 5}
    for got, want in zip(jax.tree.leaves(jrestored), jax.tree.leaves(jtree)):
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            assert got.dtype == np.dtype("V2")
            np.testing.assert_array_equal(got.view(np.uint16),
                                          want.view(np.uint16))
        else:
            np.testing.assert_array_equal(got, want)


def test_checkpoint_snapshot_is_taken_before_save_returns(tmp_path):
    """The train step updates params in place right after a save: the
    written values are those of the save call."""
    t = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    s = store.CheckpointStore(str(tmp_path))
    s.save(1, t, extra={"step": 1})
    t["w"].add_(100.0)
    restored, _ = s.restore(1, t)
    assert torch.equal(restored["w"],
                       torch.arange(6, dtype=torch.float32).reshape(2, 3))


def test_checkpoint_restore_checks_shapes_and_skips_partial_writes(tmp_path):
    s = store.CheckpointStore(str(tmp_path))
    s.save(2, {"w": torch.zeros(3)}, blocking=True, extra={"step": 2})
    (tmp_path / "step_00000009.tmp").mkdir()     # a write cut short
    assert s.latest_step() == 2
    with pytest.raises(ValueError, match="shape"):
        s.restore(2, {"w": torch.zeros(4)})


def test_checkpoint_prune_keeps_the_latest(tmp_path):
    s = store.CheckpointStore(str(tmp_path))
    js = jstore.CheckpointStore(str(tmp_path / "ref"))
    for step in (1, 2, 3, 4, 5):
        s.save(step, {"w": torch.full((2,), float(step))}, blocking=True)
        js.save(step, {"w": np.full((2,), float(step), np.float32)},
                blocking=True)
    s.prune(keep=2)
    js.prune(keep=2)
    kept = [d for d in _files(tmp_path) if d.startswith("step_")]
    assert kept == ["step_00000004", "step_00000005"]
    assert _files(tmp_path / "ref") == kept
    assert s.latest_step() == 5


# ------------------------------------------------------------- supervisor
def _tiny_training(tmp_path, name, fail_at, every=2, total=6):
    cfg = configs.get_smoke_config("qwen2.5-3b")
    shape = configs.ShapeConfig("t", 16, 2, configs.KIND_TRAIN)
    step_fn = steps.make_train_step(cfg, configs.ParallelConfig(remat="full"),
                                    adamw.AdamWConfig(total_steps=total))
    gen = torch.Generator().manual_seed(0)
    params = lm.init_model(cfg, gen, device="cpu")
    sup = ft.TrainSupervisor(store.CheckpointStore(str(tmp_path / name)),
                             checkpoint_every=every)
    state = sup.run({"params": params, "opt_state": adamw.init_state(params),
                     "step": 0}, step_fn,
                    lambda s: pipeline.batch_to(
                        pipeline.synthetic_batch(cfg, shape, s), "cpu"),
                    total, fail_at=fail_at)
    return state, sup


def test_supervisor_replays_a_failure_bit_identically(tmp_path):
    """A failure at step 3 restores the step-2 checkpoint and runs steps
    2-5 again: on the CPU the final params, moments and loss equal an
    uninterrupted run's exactly."""
    clean, sup0 = _tiny_training(tmp_path, "clean", fail_at=None)
    failed, sup1 = _tiny_training(tmp_path, "failed", fail_at=3)
    assert (sup0.restarts, sup1.restarts) == (0, 1)
    assert failed["step"] == clean["step"] == 6
    assert float(failed["metrics"]["loss"]) == float(clean["metrics"]["loss"])
    for part in ("params", "opt_state"):
        for a, b in zip(convert.flatten(failed[part])[0],
                        convert.flatten(clean[part])[0]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_supervisor_restarts_at_step_0_with_current_params(tmp_path,
                                                           package):
    """Reproduced on purpose: a failure before any checkpoint restarts at
    step 0 with the params as they are, not as they started. Steps add 1;
    a failure at step 1 of 3 ends at 4, in both packages."""
    mod, smod = (ft, store) if package == "port" else (jft, jstore)
    sup = mod.TrainSupervisor(smod.CheckpointStore(str(tmp_path)),
                              checkpoint_every=10)
    state = sup.run({"params": 0, "opt_state": None, "step": 0},
                    lambda p, o, b: (p + 1, o, {"loss": b}),
                    lambda s: s, 3, fail_at=1)
    assert (state["step"], state["params"], sup.restarts) == (3, 4, 1)


def test_supervisor_reports_each_step_it_runs(tmp_path):
    """`on_step` sees every step run, a replayed one again, with the time
    the monitor recorded and the step's metrics."""
    seen = []
    sup = ft.TrainSupervisor(store.CheckpointStore(str(tmp_path)),
                             checkpoint_every=10)
    sup.run({"params": 0, "opt_state": None, "step": 0},
            lambda p, o, b: (p + 1, o, {"loss": b}), lambda s: s, 3,
            fail_at=1, on_step=lambda *a: seen.append(a))
    assert [(s, m) for s, _, m in seen] == [
        (0, {"loss": 0}), (0, {"loss": 0}), (1, {"loss": 1}),
        (2, {"loss": 2})]
    assert all(d >= 0 for _, d, _ in seen) and sup.monitor.steps == 4


def test_step_monitor_matches_reference():
    durations = [1.0, 1.2, 0.9, 1.0, 3.5, 1.1, 0.2, 2.6, 1.0]
    seen, jseen = [], []
    mon = ft.StepMonitor(on_straggler=lambda *a: seen.append(a))
    jmon = jft.StepMonitor(on_straggler=lambda *a: jseen.append(a))
    flags = [mon.record(i, d) for i, d in enumerate(durations)]
    jflags = [jmon.record(i, d) for i, d in enumerate(durations)]
    assert flags == jflags and any(flags)
    assert mon.stragglers == jmon.stragglers
    assert mon.ewma == jmon.ewma and seen == jseen


# --------------------------------------------------------------- launcher
def test_launch_train_on_the_cpu_checkpoints_and_resumes(tmp_path, capsys):
    """--device cpu --smoke trains 4 steps with a checkpoint every 2, then
    --resume trains on to 6; the resumed run ends where an uninterrupted
    6-step run ends."""
    ck = str(tmp_path / "ck")
    base = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "16", "--checkpoint-every", "2",
            "--checkpoint-dir", ck]
    train_mod.main(base + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "done: 4 steps, final loss" in out and "step 3: loss" in out
    assert _files(ck) == ["step_00000002", "step_00000004"]
    train_mod.main(base + ["--steps", "6", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "done: 6 steps" in out
    assert "step 3:" not in out
    resumed = store.CheckpointStore(ck)
    assert resumed.latest_step() == 6
    straight = train_mod.train("qwen2.5-3b", smoke=True, steps=6, batch=2,
                               seq=16, checkpoint_every=2, device="cpu",
                               checkpoint_dir=str(tmp_path / "straight"))
    got, _ = resumed.restore(6, {"params": straight["state"]["params"]})
    for a, b in zip(convert.flatten(got)[0],
                    convert.flatten(straight["state"]["params"])[0]):
        assert torch.equal(a, b)


def test_launch_train_wants_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train_mod.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "1"])


def test_launch_train_has_no_production_mesh():
    """At world size 1 there is no production mesh: it needs 256 ranks, and
    the error names both counts."""
    with pytest.raises(ValueError, match="needs a world size of 256, this "
                       "process group has 1"):
        train_mod.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                        "--production-mesh"])
