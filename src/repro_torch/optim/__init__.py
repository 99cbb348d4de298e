"""Optimizer of the port: AdamW (`optim.adamw`)."""
from repro_torch.optim import adamw  # noqa: F401
from repro_torch.optim.adamw import AdamWConfig  # noqa: F401
