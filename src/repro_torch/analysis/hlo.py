"""HLO-text analysis: collective ops and their traffic.

``cost_analysis()`` does not report collective bytes, so we parse the
compiled module text: every ``all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute`` instruction, its result shape, and its
replica group size.

Per-device *link traffic* model (ring algorithms, n = group size):
    all-reduce:         2 (n-1)/n x elem_bytes      (reduce-scatter+all-gather)
    all-gather:           (n-1)/n x out_bytes        (out = gathered)
    reduce-scatter:       (n-1)   x out_bytes        (in = n x out moves)
    all-to-all:           (n-1)/n x out_bytes
    collective-permute:             out_bytes
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
# e.g.  %x = f32[32,128]{1,0} all-reduce(  OR  (f32[..], f32[..]) all-gather-start(
_INSTR_RE = re.compile(
    r"=\s*(?P<shapes>\([^)]*\)|\S+)\s+(?P<kind>"
    + "|".join(_KINDS)
    + r")(?P<variant>-start|-done)?\("
)
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    out_bytes: int
    group_size: int
    dtype: str = ""

    @property
    def traffic_bytes(self) -> float:
        n = max(self.group_size, 1)
        if n == 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * (n - 1) / n * self.out_bytes
        if self.kind == "all-gather":
            return (n - 1) / n * self.out_bytes
        if self.kind == "reduce-scatter":
            return float(n - 1) * self.out_bytes
        if self.kind == "all-to-all":
            return (n - 1) / n * self.out_bytes
        if self.kind == "collective-permute":
            return float(self.out_bytes)
        raise ValueError(self.kind)

    @property
    def traffic_bytes_tpu(self) -> float:
        """TPU-pipeline-corrected estimate (documented in EXPERIMENTS.md
        §Perf iteration F): the XLA *CPU* SPMD pipeline (the compile host)
        (a) upcasts bf16 dot operands to f32 BEFORE placing the collective
        and (b) lacks the TPU pipeline's all-reduce→reduce-scatter rewrite
        for sliced consumers. Correction for large activation collectives:
        f32 ⇒ ×0.5 (bf16 on TPU); activation all-reduce ⇒ ×0.5 (RS)."""
        t = self.traffic_bytes
        if self.out_bytes < 4 * 1024 * 1024:
            return t  # small tensors: keep as compiled
        if self.dtype == "f32":
            t *= 0.5
        if self.kind == "all-reduce":
            t *= 0.5
        return t


def _shape_bytes(shape_text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def parse_collectives(hlo_text: str) -> list[CollectiveOp]:
    ops: list[CollectiveOp] = []
    for line in hlo_text.splitlines():
        m = _INSTR_RE.search(line)
        if not m:
            continue
        if m.group("variant") == "-done":
            continue  # counted at -start
        out_bytes = _shape_bytes(m.group("shapes"))
        gsize = 0
        gm = _GROUPS_IOTA_RE.search(line)
        if gm:
            gsize = int(gm.group(2))
        else:
            gl = _GROUPS_LIST_RE.search(line)
            if gl:
                gsize = len([t for t in gl.group(1).split(",") if t.strip()])
        dm = _SHAPE_RE.search(m.group("shapes"))
        dtype = dm.group(1) if dm else ""
        ops.append(CollectiveOp(m.group("kind"), out_bytes, gsize or 1, dtype))
    return ops


def collective_bytes_per_device(hlo_text: str) -> dict:
    ops = parse_collectives(hlo_text)
    by_kind: dict[str, dict] = {}
    total = 0.0
    total_tpu = 0.0
    for op in ops:
        d = by_kind.setdefault(op.kind, {"count": 0, "traffic_bytes": 0.0,
                                         "payload_bytes": 0})
        d["count"] += 1
        d["traffic_bytes"] += op.traffic_bytes
        d["payload_bytes"] += op.out_bytes
        total += op.traffic_bytes
        total_tpu += op.traffic_bytes_tpu
    return {"total_traffic_bytes": total,
            "total_traffic_bytes_tpu": total_tpu,
            "by_kind": by_kind, "n_ops": len(ops)}
