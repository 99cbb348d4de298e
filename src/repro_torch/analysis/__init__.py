"""Protocol-correctness tooling for the AMI contract.

Two complementary checkers over the same protocol rules (leaked request
IDs, SPM/DMA races, lock discipline):

* :mod:`repro_torch.analysis.amilint` — static AST + abstract-interpretation
  lint over port generators (``tools/amilint.py`` is the CLI).
* :mod:`repro_torch.analysis.sanitizer` — the ``AmuConfig(sanitize=True)``
  runtime shadow-state checker that wraps any engine/scheduler pair
  (scalar, batched, epoch-fused, every core of a rack) with pure
  observation: bit-identical traces/stats/RNG whether on or off.

The port's own copy of the reference's `repro.analysis`: numpy and the
standard library only, the same logic line for line, so the scalar and
batched engines, the schedulers and the workloads give the same traces and
stats in both packages; `tests/test_torch_sim_*.py` hold the two copies
equal, and a change to one lands in the other.
"""
from repro_torch.analysis.amilint import (Finding, lint_file, lint_registry,
                                          lint_source)
from repro_torch.analysis.sanitizer import AmiProtocolError, AmiSanitizer

__all__ = [
    "AmiProtocolError", "AmiSanitizer",
    "Finding", "lint_source", "lint_file", "lint_registry",
]
