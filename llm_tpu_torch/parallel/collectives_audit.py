"""Collective audit: which mesh axis does each collective cross, and how
many bytes a step move on each axis?

The counterpart of `llm_tpu/parallel/collectives_audit.py`. The JAX
package parses the collectives out of a compiled step's HLO; a torch step
has no such program, so the port's collective helpers (`sharding.
all_reduce`, `all_gather`, `broadcast`, `sendrecv`) record each op they
issue, with its group's global ranks and its payload bytes, while
`audit_step` runs one step. `classify_groups` maps a group onto the axes
of the mesh (ranks index `mesh.devices.flat`), as the reference's does.

Payload bytes follow the reference's HLO accounting: an all-reduce and a
broadcast count their tensor, an all-gather its gathered result, a
send-receive the tensor sent.

Control traffic (`multihost.ControlGroups`: the hosts' integers and the
row's pickled requests, on gloo groups of their own) is recorded apart,
on the axis "control", so that a step's tensor bytes by mesh axis stay
what the device moved.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


@dataclass
class CollectiveOp:
    op: str
    axis: str  # "model" | "data" | ... | "mixed" | "replicated"
    bytes: int
    groups: list
    line: str


@dataclass
class AuditResult:
    ops: list = field(default_factory=list)

    @property
    def bytes_by_axis(self) -> dict:
        out: dict = {}
        for o in self.ops:
            out[o.axis] = out.get(o.axis, 0) + o.bytes
        return out

    def table(self) -> str:
        lines = ["axis        ops   bytes/step"]
        per_axis: dict = {}
        for o in self.ops:
            per_axis.setdefault(o.axis, []).append(o)
        axes = ["model", "data", "mixed", "replicated"]
        axes += sorted(a for a in per_axis if a not in axes)
        for axis in axes:
            ops = per_axis.get(axis, [])
            lines.append(
                f"{axis:10} {len(ops):4}   {sum(o.bytes for o in ops)}"
            )
        return "\n".join(lines)


def classify_groups(groups: "list[list[int]]", mesh) -> str:
    """Which mesh axis a collective's groups span. Ranks index
    mesh.devices.flat (row-major over the mesh's axes)."""
    shape = mesh.devices.shape
    names = list(mesh.axis_names)
    coords = {
        i: np.unravel_index(i, shape) for i in range(mesh.devices.size)
    }
    crossed = set()
    for g in groups:
        if len(g) < 2:
            continue
        cs = [coords[p] for p in g]
        for ax in range(len(shape)):
            if len({c[ax] for c in cs}) > 1:
                crossed.add(names[ax])
    if not crossed:
        return "replicated"
    if len(crossed) == 1:
        return next(iter(crossed))
    return "mixed"


# the ops recorded while `audit_step` runs (None: not recording)
_RECORD: Optional[list] = None


def note(op: str, mesh, ranks: "list[int]", nbytes: int, what: str) -> None:
    """Record one collective a helper issues (a no-op unless audit_step
    is running)."""
    if _RECORD is None:
        return
    _RECORD.append(CollectiveOp(op, classify_groups([ranks], mesh), nbytes,
                                [list(ranks)], what))


def recording() -> bool:
    """Whether audit_step is running (a helper may skip the work of
    sizing a payload otherwise)."""
    return _RECORD is not None


def note_control(op: str, ranks: "list[int]", nbytes: int,
                 what: str) -> None:
    """Record one control collective, on the axis "control" (a no-op
    unless audit_step is running)."""
    if _RECORD is None:
        return
    _RECORD.append(CollectiveOp(op, "control", nbytes, [list(ranks)], what))


def audit_step(fn: Callable[[], object], mesh) -> AuditResult:
    """Run fn() (one step) and return the collectives this rank issued in
    it, each classified on `mesh`."""
    global _RECORD
    _RECORD = []
    try:
        fn()
        return AuditResult(ops=_RECORD)
    finally:
        _RECORD = None
