"""Strategy registry: pluggable schedule families for the unified Planner.

A *strategy* is a generator of candidate schedules for one planning request:

    @register_strategy("my-family", kinds=("rs",), paper_faithful=False)
    def my_family(req: PlanRequest, kind: Collective):
        yield Candidate("my-family(R=1)", some_schedule)

New families (e.g. reconfiguration/communication-overlap or circuit-switched
variants from PAPERS.md) plug in by registering — no edits to the planner or
to `core.schedules.candidate_schedules` required.  Strategies are selected
per request: by explicit name (``PlanRequest.strategies``), else every
strategy registered with ``default=True``; a ``paper_faithful`` request
additionally drops strategies marked ``paper_faithful=False``.

Iteration order is registration order, which also breaks exact ties during
selection (first minimum wins), so built-ins register the paper's families
first.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator

from .api import Candidate, PlanRequest

#: fn(request, kind) -> iterable of Candidate, where ``kind`` is the concrete
#: sub-collective being planned ('rs'/'ag' for the two phases of an 'ar').
StrategyFn = Callable[[PlanRequest, str], Iterable[Candidate]]


@dataclasses.dataclass(frozen=True)
class StrategyInfo:
    name: str
    fn: StrategyFn
    kinds: frozenset[str]
    paper_faithful: bool  # survives a paper_faithful request
    default: bool         # selected when the request names no strategies
    doc: str = ""


_REGISTRY: dict[str, StrategyInfo] = {}


def register_strategy(name: str, *, kinds: Iterable[str] = ("a2a", "rs", "ag"),
                      paper_faithful: bool = True,
                      default: bool = True) -> Callable[[StrategyFn], StrategyFn]:
    """Decorator registering a strategy family under ``name``.

    kinds          : collectives the family can plan ('ar' only for families
                     that are implementation-level AllReduce alternatives).
    paper_faithful : keep the family when a request asks for paper-faithful
                     planning (False for beyond-paper families).
    default        : include in the candidate set when a request does not
                     name strategies explicitly.
    """

    def deco(fn: StrategyFn) -> StrategyFn:
        if name in _REGISTRY:
            raise ValueError(f"strategy {name!r} is already registered")
        doc_lines = (fn.__doc__ or "").strip().splitlines()
        _REGISTRY[name] = StrategyInfo(
            name=name, fn=fn, kinds=frozenset(kinds),
            paper_faithful=paper_faithful, default=default,
            doc=doc_lines[0] if doc_lines else "")
        return fn

    return deco


def unregister_strategy(name: str) -> None:
    """Remove a registered strategy (primarily for tests/plugins)."""
    _REGISTRY.pop(name, None)


def get_strategy(name: str) -> StrategyInfo:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; registered: {sorted(_REGISTRY)}") from None


def available_strategies() -> tuple[str, ...]:
    """All registered strategy names, in registration order."""
    return tuple(_REGISTRY)


def default_strategy_names() -> tuple[str, ...]:
    """Names selected when a request does not specify strategies."""
    return tuple(si.name for si in _REGISTRY.values() if si.default)


def select_strategies(req: PlanRequest, kind: str) -> Iterator[StrategyInfo]:
    """Strategies participating in planning ``kind`` under ``req``."""
    if req.strategies is not None:
        infos = [get_strategy(nm) for nm in req.strategies]
    else:
        infos = [si for si in _REGISTRY.values() if si.default]
    for si in infos:
        if kind not in si.kinds:
            continue
        if req.paper_faithful and not si.paper_faithful:
            continue
        yield si
