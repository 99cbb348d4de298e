"""What `paged_phases.py` and `flash_phases.py` share: a stamped copy of one
kernel source of a tree, its build and its reader, the SM clock, the
command line and the closing lines.

A tool gives its source, its text edits (each must be in the source
exactly once, as a mutant's of chip_smoke.py) and the shape of its
`__device__` array of clock64() stamps, `rows` x `slots` words; the copy
gets that array and an `extern "C"` pair, `<symbol>_clear` and
`<symbol>_read`, that clear it before a launch and read it after.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from typing import Callable, Sequence, Tuple, Union

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# (text in the source, what replaces it, or a function of the text found
# that makes it); a tuple of texts is the forms of one place in trees from
# before and after a redesign, the first found replaced
Edit = Tuple[Union[str, Tuple[str, ...]], Union[str, Callable[[str], str]]]


def reader(symbol: str, rows: int, slots: int) -> str:
    """The `extern "C"` clear and read of the stamps' array."""
    return f"""
// The stamps of the last launch (clear before it): {rows} x {slots} words.
extern "C" int {symbol}_clear() {{
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, {symbol});
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(p, 0, sizeof({symbol}));
}}

extern "C" int {symbol}_read(void* host) {{
  return (int)cudaMemcpyFromSymbol(host, {symbol},
                                   sizeof({symbol}));
}}
"""


def make_copy(src: str, tool: str, label: str, source: str,
              edits: Sequence[Edit], symbol: str, rows: int,
              slots: int) -> str:
    """The copy of `src` under build/TOOL/LABEL with `source` (a file of
    csrc/) edited: the stamps' array after its includes, `edits`, and the
    reader at its end; returns the copy's `src` directory."""
    dst = os.path.join(ROOT, "build", tool, label)
    shutil.rmtree(os.path.join(dst, "src"), ignore_errors=True)
    shutil.copytree(src, os.path.join(dst, "src"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, "src", "repro_torch", "kernels", "csrc",
                        source)
    with open(path) as f:
        text = f.read()
    array = ('#include "hopper.cuh"\n',
             '#include "hopper.cuh"\n\n'
             f'__device__ unsigned long long {symbol}[{rows}][{slots}];\n')
    for old, new in (array, *edits):
        if isinstance(old, tuple):          # the form this tree has
            old = next((o for o in old if o in text), old[0])
        if callable(new):
            new = new(old)
        if text.count(old) != 1:
            raise AssertionError(f"{tool}: {old!r} is not in {path} "
                                 "exactly once")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text + reader(symbol, rows, slots))
    return os.path.join(dst, "src")


def parse_args(doc: str, tool: str, cases: Sequence[str],
               bodies: Sequence[str] = ()):
    """The tools' command line (`--body`, the first of `bodies` by default,
    where a tool stamps one of several bodies); None (after saying why)
    where a run without --build-only has no card."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    if bodies:
        ap.add_argument("--body", choices=list(bodies), default=bodies[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this-tree")
    ap.add_argument("--case", nargs="*", default=list(cases))
    ap.add_argument("--build-only", action="store_true",
                    help="build the stamped copy and stop (a later run "
                         "with the same --src and --label reuses it)")
    args = ap.parse_args()
    if not args.build_only and not torch.cuda.is_available():
        print(f"{tool}: torch.cuda.is_available() is False", file=sys.stderr)
        return None
    return args


def build(copy: str, stem: str, symbol: str, label: str):
    """Puts the copy first on the path and builds its `stem`.cu alone;
    returns the library and the copy's `_build`."""
    sys.path.insert(0, copy)
    from repro_torch.kernels import _build
    _build._sources = lambda: [_build.CSRC / f"{stem}.cu"]
    lib = _build.load(stem)
    getattr(lib, f"{symbol}_read").argtypes = [ctypes.c_void_p]
    print(f"{label}: built the stamped copy in "
          f"{_build.build_seconds or 0.0:.1f} s", flush=True)
    return lib, _build


def stamps(lib, build_mod, symbol: str, rows: int, slots: int,
           launch: Callable[[], object]) -> torch.Tensor:
    """The stamps of one `launch()`, [rows, slots] in float64."""
    build_mod.check(lib, getattr(lib, f"{symbol}_clear")(), "clear")
    launch()
    torch.cuda.synchronize()
    host = (ctypes.c_ulonglong * (rows * slots))()
    build_mod.check(lib, getattr(lib, f"{symbol}_read")(host), "read")
    return torch.tensor(list(host), dtype=torch.float64).view(rows, slots)


def sm_hz() -> float:
    """The SM clock under load: cycles of a sleep kernel over its event
    time."""
    cycles = 20_000_000
    torch.cuda._sleep(cycles)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    stop.record()
    torch.cuda.synchronize()
    return cycles / (start.elapsed_time(stop) * 1e-3)


def close(label: str, src: str, results: list) -> None:
    """The JSON line of the run, then the card's name and power limit."""
    print(json.dumps({"label": label, "src": src, "phases": results}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
