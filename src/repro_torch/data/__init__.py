"""Data of the port: the deterministic synthetic batches and their loader."""
from repro_torch.data.pipeline import (  # noqa: F401
    PrefetchingLoader, synthetic_batch)
