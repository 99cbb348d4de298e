"""Data: the deterministic synthetic token batches, with a loader that makes
them ahead on a thread (the paper's pattern at the pipeline level: issue the
next batch while the step computes).

The counterpart of `src/repro/data/pipeline.py`. `synthetic_batch` is the
reference's numpy code, so the same (step, seed) gives the same arrays in
both packages. `input_specs` is the dry-run contract: meta tensors standing
for every model input of an (arch x shape) cell, allocation-free.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import (KIND_DECODE, KIND_PREFILL, KIND_TRAIN,
                                      ModelConfig, ShapeConfig)


# ------------------------------------------------------------- dry-run specs
def input_specs(model: ModelConfig, shape: ShapeConfig,
                sharding_fn=None) -> Dict[str, torch.Tensor]:
    """A meta tensor (`device="meta"`: shape and type, no storage) for
    every model input, with the reference's shapes and types.

    `sharding_fn(logical_name)` -> a `runtime.sharding.Sharding` or None;
    where it gives one, the input is a DTensor on it (its local shard a
    meta tensor too)."""
    B, S = shape.global_batch, shape.seq_len

    def spec(shp, dtype, name):
        t = torch.empty(shp, dtype=dtype, device="meta")
        sh = sharding_fn(name) if sharding_fn else None
        if sh is None:
            return t
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, sh.mesh, sh.placements)

    specs: Dict[str, torch.Tensor] = {}
    if shape.kind in (KIND_TRAIN, KIND_PREFILL):
        if model.frontend is not None and model.frontend.kind == "audio":
            specs["features"] = spec((B, S, model.frontend.feature_dim),
                                     torch.bfloat16, "activations")
        else:
            specs["tokens"] = spec((B, S), torch.int32, "tokens")
        if shape.kind == KIND_TRAIN:
            specs["labels"] = spec((B, S), torch.int32, "tokens")
        if model.frontend is not None and model.frontend.kind == "vision":
            specs["vision_embeds"] = spec(
                (B, model.frontend.prefix_len, model.frontend.feature_dim),
                torch.bfloat16, "activations")
    else:  # decode: one new token per sequence; the KV/state cache rides
        specs["tokens"] = spec((B, 1), torch.int32, "tokens")
    return specs


def synthetic_batch(model: ModelConfig, shape: ShapeConfig, step: int,
                    seed: int = 0,
                    batch_override: Optional[int] = None) -> Dict[str, Any]:
    """Deterministic numpy batch for (step, seed): restart-safe, a resumed
    run sees exactly the data it would have seen."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    batch: Dict[str, Any] = {}
    if shape.kind == KIND_DECODE:
        batch["tokens"] = rng.integers(0, model.vocab_size, (B, 1),
                                       dtype=np.int32)
        return batch
    if model.frontend is not None and model.frontend.kind == "audio":
        batch["features"] = rng.standard_normal(
            (B, S, model.frontend.feature_dim)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, model.vocab_size, (B, S),
                                       dtype=np.int32)
    if shape.kind == KIND_TRAIN:
        batch["labels"] = rng.integers(0, model.vocab_size, (B, S),
                                       dtype=np.int32)
    if model.frontend is not None and model.frontend.kind == "vision":
        batch["vision_embeds"] = rng.standard_normal(
            (B, model.frontend.prefix_len,
             model.frontend.feature_dim)).astype(np.float32)
    return batch


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on `device` (a synchronous copy)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class PrefetchingLoader:
    """A producer thread keeps `depth` batches ready while the train step
    runs: `aload` at the pipeline level, issue ahead, consume on demand.
    Yields (step, batch). With no `device` the batch is numpy, as made; on
    the CPU it is tensors; for a CUDA device the producer puts each array in
    pinned host memory and the consumer's `next` issues the copy to the
    card on its current stream (non-blocking), so whatever the consumer
    then runs on that stream sees the copy complete."""

    def __init__(self, model: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 depth: int = 2, start_step: int = 0, device=None,
                 batch_override: Optional[int] = None):
        self.model, self.shape, self.seed = model, shape, seed
        self.device = None if device is None else torch.device(device)
        self.batch_override = batch_override
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        step = self._step
        pin = self.device is not None and self.device.type == "cuda"
        while not self._stop.is_set():
            batch = synthetic_batch(self.model, self.shape, step, self.seed,
                                    self.batch_override)
            if self.device is not None:
                batch = {k: torch.from_numpy(v) for k, v in batch.items()}
                if pin:
                    batch = {k: v.pin_memory() for k, v in batch.items()}
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        if self.device is not None and self.device.type == "cuda":
            batch = {k: v.to(self.device, non_blocking=True)
                     for k, v in batch.items()}
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
