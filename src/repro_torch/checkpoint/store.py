"""Checkpoints: a synchronous snapshot to host memory, an asynchronous atomic
write, manifest-driven restore.

The counterpart of `src/repro/checkpoint/store.py`, in its on-disk layout,
so a checkpoint written by either package restores in the other:

    <dir>/step_<N:08d>/manifest.json + leaf_<i>.npy

Leaves are numbered in `jax.tree.flatten`'s order (`convert.flatten`) and
named by `jax.tree_util.keystr`'s path strings (`['params']['scan'][0]
['mix']['wq']`). A bfloat16 leaf is written as the reference's numpy writes
an `ml_dtypes` bfloat16 array: its 16 bits under the header type `<V2`, with
`"bfloat16"` in the manifest, which is what restore reads it back by. A
write goes to `step_<N>.tmp` and is renamed when complete, so a crash never
leaves a half-written checkpoint under the final name. `save` returns once
the snapshot is a host copy of its own (the train step updates params and
optimizer state in place); the disk write runs on a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.convert import flatten, keystr_paths, unflatten

Params = Any


def _host_copy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(numpy array of the leaf's own, its dtype name). bfloat16 becomes its
    16 bits as uint16. A DTensor is gathered whole first (every rank of its
    mesh takes part)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    # the header np.save writes for an ml_dtypes bfloat16 array
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointStore:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Params, blocking: bool = False,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot now (a host copy of every leaf), write asynchronously
        unless `blocking`. In a process group every rank snapshots (a
        sharded leaf is gathered) and rank 0 alone writes."""
        self.wait()                                  # one writer at a time
        leaves, _ = flatten(tree)
        paths = keystr_paths(tree)
        host = [_host_copy(t) for t in leaves]
        manifest = {
            "step": step,
            "leaves": [{"path": p, "shape": list(a.shape), "dtype": dt,
                        "file": f"leaf_{i}.npy"}
                       for i, (p, (a, dt)) in enumerate(zip(paths, host))],
            "extra": extra or {},
        }

        def write():
            final = os.path.join(self.dir, f"step_{step:08d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for i, (arr, dt) in enumerate(host):
                _save_leaf(os.path.join(tmp, f"leaf_{i}.npy"), arr, dt)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)

        if dist.is_initialized() and dist.get_rank() != 0:
            return
        if blocking:
            write()
            return

        def run():
            try:
                write()
            except BaseException as exc:          # re-raised by wait()
                self._error = exc

        self._pending = threading.Thread(target=run, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        """Block until the background write is done; a write that failed
        raises here."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    # -------------------------------------------------------------- restore
    def _steps(self) -> List[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Params, sharding_fn=None
                ) -> Tuple[Params, Dict[str, Any]]:
        """Restore into the structure of `like`: each leaf lands on the
        device of `like`'s leaf at its path, in the type the manifest
        names. The writer's devices are irrelevant (leaves are stored
        whole). `sharding_fn(path, leaf)`, where given, returns the target
        `runtime.sharding.Sharding` of the leaf at `path`: the stored whole
        leaf is then distributed onto it (`distribute_tensor`), so a
        checkpoint restores onto any mesh, whatever the writer's layout."""
        self.wait()
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
        leaves, treedef = flatten(like)
        out = []
        for key, leaf in zip(keystr_paths(like), leaves):
            rec = by_path[key]
            t = _load_leaf(os.path.join(d, rec["file"]), rec["dtype"])
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key} has shape "
                                 f"{tuple(t.shape)}, want {tuple(leaf.shape)}")
            if sharding_fn is None:
                out.append(t.to(leaf.device))
                continue
            sh = sharding_fn(key, leaf)
            device = sh.mesh.device_type
            out.append(distribute_tensor(t.to(device), sh.mesh,
                                         sh.placements))
        return unflatten(treedef, out), manifest["extra"]

    def prune(self, keep: int = 3) -> None:
        self.wait()
        for s in self._steps()[:-keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"))
