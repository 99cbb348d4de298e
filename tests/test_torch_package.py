"""The port stands alone: it imports neither `jax` nor the reference package,
imports with no CUDA, no `nvcc` and no `triton`, and its copy of the configs
cannot drift from the reference's."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

from repro import configs as jconfigs
from repro_torch import configs

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro", "ml_dtypes"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "kernel_bench.py",
                    ROOT / "train_bench.py"]


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for want in ("chip_smoke.py", "kernel_bench.py", "train_bench.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/kernels/paged_attention.py",
                 "src/repro_torch/kernels/flash_attention.py",
                 "src/repro_torch/kernels/async_gather.py",
                 "src/repro_torch/kernels/async_scatter.py",
                 "src/repro_torch/kernels/stream_triad.py",
                 "src/repro_torch/launch/quickstart.py",
                 "src/repro_torch/runtime/offload.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/models/frontends.py",
                 "src/repro_torch/models/rwkv6.py",
                 "src/repro_torch/models/rglru.py",
                 "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/runtime/steps.py",
                 "src/repro_torch/runtime/ft.py",
                 "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/checkpoint/store.py",
                 "src/repro_torch/launch/train.py"):
        assert want in names
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert {p.name for p in csrc.iterdir()} >= {
        "common.cuh", "amu_ring.cuh", "hopper.cuh", "paged_attention.cu",
        "flash_attention.cu", "async_gather.cu", "async_scatter.cu",
        "stream_triad.cu"}


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_import_of_jax_or_the_reference_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in FORBIDDEN, \
                f"{path}: imports {mod} (line {node.lineno})"


def test_importing_the_port_pulls_in_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.kernels.ops\n"
        "import repro_torch.models.moe, repro_torch.models.frontends\n"
        "import repro_torch.models.rwkv6\n"
        "import repro_torch.launch.quickstart\n"
        "import repro_torch.launch.train, repro_torch.optim\n"
        "import repro_torch.data, repro_torch.checkpoint\n"
        "import repro_torch.kernels._build, repro_torch.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
@pytest.mark.parametrize("which", ["CONFIG", "smoke"])
def test_config_copy_equals_reference(arch, which):
    get = "get_config" if which == "CONFIG" else "get_smoke_config"
    mine, theirs = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.param_count() == theirs.param_count()
    assert mine.active_param_count() == theirs.active_param_count()
    assert mine.layer_kinds == theirs.layer_kinds
    assert mine.is_subquadratic == theirs.is_subquadratic


def test_config_registry_and_shapes_equal_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.all_cells() == jconfigs.all_cells()
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for cls in ("ParallelConfig", "EngineConfig"):
        assert dataclasses.asdict(getattr(configs, cls)()) == \
            dataclasses.asdict(getattr(jconfigs, cls)())
    for name in ("BLOCK_FULL", "BLOCK_LOCAL", "BLOCK_RGLRU", "BLOCK_RWKV6",
                 "KIND_TRAIN", "KIND_PREFILL", "KIND_DECODE"):
        assert getattr(configs, name) == getattr(jconfigs, name)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-arch")


def test_kernel_build_is_lazy_and_fails_loudly_without_nvcc(monkeypatch,
                                                            tmp_path):
    """Nothing is built at import; where there is no compiler, asking for a
    kernel raises (no fallback)."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("paged_attention")
    with pytest.raises(RuntimeError, match="no kernel source"):
        _build.load("no_such_kernel")
    assert not any(tmp_path.iterdir())
