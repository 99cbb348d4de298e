"""Pluggable workload registry: the ``@workload`` decorator + Port protocol.

One registry replaces the old ``WORKLOADS`` dict / ``VECTOR_WORKLOADS``
frozenset pair: each entry is a :class:`WorkloadDef` that names its builder,
its baseline :class:`~repro_torch.core.workloads.IterationProfile`, and its
*capabilities* — whether it carries a vector (``AloadVec``/``AstoreVec``)
port, whether that port is a software-pipelined chase (``pipeline_k`` knob),
whether it uses Acquire/Release disambiguation, whether it supports a
``distinct=`` determinism knob, and any LLVM-mode rebuild kwargs. The
session layer (:class:`repro_torch.amu.AmuSession`) consults these capabilities
instead of hard-coding workload names.

Adding a new scenario is one decorated builder function::

    @workload("MYWL", profile=IterationProfile(insts=10, indep_loads=1),
              description="my far-memory scan")
    def build_mywl(seed: int = 0, n: int = 4096) -> WorkloadInstance:
        ...

after which ``AmuSession(cfg).run("MYWL")`` just works — see
``examples/amu_workload.py`` for a complete worked example.

This module is import-cycle-free by design: it depends on nothing inside
``repro_torch`` (the Port protocol is structural), so both ``repro_torch.core`` and
``repro_torch.amu`` can import it freely.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Protocol, Tuple, runtime_checkable)


@runtime_checkable
class Port(Protocol):
    """What :meth:`repro_torch.amu.AmuSession.run` needs from a built workload.

    ``WorkloadInstance`` satisfies this structurally; any user object with
    these attributes runs through the session the same way. Frontier-
    parallel ports (BFS) additionally provide ``make_round_tasks(frontier)``,
    ``next_frontier`` and ``root``, and instances built through
    :meth:`WorkloadRegistry.build` carry a ``vector`` attribute recording
    which port was selected — all detected by attribute, not declared here,
    so minimal ports need no stubs.
    """
    name: str
    mem: Any                      # numpy uint8 far-memory backing
    tasks: List                   # generator tasks yielding AMI commands
    units: int                    # logical work units (for rates)
    engine_config: Any            # EngineConfig the port was sized for
    verify: Callable[[Any], bool]
    disambiguation: bool


@dataclass(frozen=True)
class WorkloadDef:
    """A registered workload: builder + profile + declared capabilities."""
    name: str
    build: Callable[..., Port]            # (seed, **knobs) -> Port
    profile: Any = None                   # IterationProfile (window model)
    description: str = ""
    # capabilities ---------------------------------------------------------
    vector: bool = False        # has an AloadVec/AstoreVec port (vector=True)
    pipelined: bool = False     # vector port is a pipelined chase (pipeline_k)
    locked: bool = False        # uses Acquire/Release disambiguation
    distinct: bool = False      # supports the distinct= determinism knob
    frontier: bool = False      # level-synchronous (make_round_tasks driver)
    request_level: bool = False  # open-loop arrivals + per-request latency;
    #                              excluded from throughput-normalized sweeps
    #                              (its cycles include arrival-horizon idle)
    llvm_defaults: Optional[Mapping[str, Any]] = None  # llvm-mode rebuild kw
    defaults: Mapping[str, Any] = field(default_factory=dict)  # default sizes


class WorkloadRegistry:
    """Name -> :class:`WorkloadDef` mapping with capability-aware builds."""

    def __init__(self) -> None:
        self._defs: Dict[str, WorkloadDef] = {}

    def register(self, wd: WorkloadDef) -> WorkloadDef:
        if wd.name in self._defs:
            raise ValueError(f"workload {wd.name!r} already registered")
        self._defs[wd.name] = wd
        return wd

    def __getitem__(self, name: str) -> WorkloadDef:
        try:
            return self._defs[name]
        except KeyError:
            raise KeyError(f"unknown workload {name!r}; "
                           f"known: {sorted(self._defs)}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._defs

    def __iter__(self) -> Iterator[str]:
        return iter(self._defs)

    def __len__(self) -> int:
        return len(self._defs)

    def names(self) -> List[str]:
        return list(self._defs)

    def items(self) -> Iterator[Tuple[str, WorkloadDef]]:
        return iter(self._defs.items())

    def vector_names(self) -> List[str]:
        return [n for n, d in self._defs.items() if d.vector]

    def source_files(self) -> List[str]:
        """Deduplicated source files of every registered builder, for
        static analysis (``tools/amilint.py``). Builders whose source is
        unavailable (C extensions, REPL definitions) are skipped."""
        import inspect

        seen: Dict[str, None] = {}
        for wd in self._defs.values():
            try:
                path = inspect.getsourcefile(wd.build)
            except TypeError:
                path = None
            if path:
                seen.setdefault(path)
        return list(seen)

    def build(self, name: str, seed: int = 0, *, vector: bool = False,
              llvm_mode: bool = False, pipeline_k: Optional[int] = None,
              **knobs: Any) -> Port:
        """Build a workload instance honouring declared capabilities.

        ``vector=True`` selects the vector port only where one is declared
        (mirroring the old ``spec.name in VECTOR_WORKLOADS`` guard);
        ``pipeline_k`` reaches only pipelined ports; ``llvm_mode`` rebuilds
        with the workload's declared LLVM-lowering kwargs (scalar port —
        the current LLVM pass emits no vector AMIs).
        """
        wd = self[name]
        kw = dict(wd.defaults)
        kw.update(knobs)
        use_vector = False
        if llvm_mode and wd.llvm_defaults is not None:
            kw.update(wd.llvm_defaults)      # scalar port, LLVM lowering
        elif vector and wd.vector:
            use_vector = True
            kw["vector"] = True
            if pipeline_k is not None and wd.pipelined:
                kw["pipeline_k"] = pipeline_k
        inst = wd.build(seed, **kw)
        if getattr(inst, "vector", None) is None:
            # stamp which port was actually selected, so downstream stats
            # label the run truthfully even when the instance is handed to
            # a session whose config differs
            inst.vector = use_vector         # type: ignore[attr-defined]
        return inst


#: The process-wide registry the built-in workloads register into.
REGISTRY = WorkloadRegistry()


def workload(name: str, *, profile: Any = None, description: str = "",
             registry: WorkloadRegistry = REGISTRY,
             **capabilities: Any) -> Callable[[Callable[..., Port]],
                                              Callable[..., Port]]:
    """Register a builder function as a workload (decorator form).

    ``capabilities`` are the :class:`WorkloadDef` capability fields
    (``vector=``, ``pipelined=``, ``locked=``, ``distinct=``, ``frontier=``,
    ``llvm_defaults=``, ``defaults=``).
    """
    def deco(fn: Callable[..., Port]) -> Callable[..., Port]:
        registry.register(WorkloadDef(name=name, build=fn, profile=profile,
                                      description=description,
                                      **capabilities))
        return fn
    return deco
