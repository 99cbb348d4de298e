"""Checkpoints of the port, in the reference's on-disk layout."""
from repro_torch.checkpoint.store import CheckpointStore  # noqa: F401
