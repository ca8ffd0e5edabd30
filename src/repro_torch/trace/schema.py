"""Versioned JSONL trace schema (v1).

A trace file is one JSON header line followed by one JSON array per
record. The header pins schema name/version and the trace *kind*:

* ``decisions`` — the raw decision/event stream of a recorded run
  (what ``TraceRecorder`` writes).
* ``workload``  — a replayable workload: jobs, tasks with op lists,
  width/control events (what the synthesizers and the decision-stream
  reconstruction produce).

Decision records are ``[code, t, a, b]`` with two-letter codes; body ops
are compact arrays (``["c", dt, flops]`` for compute, …). Floats round-trip
exactly through JSON (``repr`` shortest-float), which the bit-identical
replay diff relies on.
"""

from __future__ import annotations

import json
from math import isfinite as _isfinite
from typing import Any, Iterable, Iterator, Optional, TextIO, Union

from repro_torch.core.scheduler import (
    REC_ATTACH,
    REC_BLOCK,
    REC_DEMOTE,
    REC_DETACH,
    REC_DISPATCH,
    REC_DL_POST,
    REC_DL_RETIRE,
    REC_DONE,
    REC_JOB,
    REC_OP,
    REC_PREEMPT,
    REC_REQ_DONE,
    REC_REQUEST,
    REC_RESIZE,
    REC_SPAWN,
    REC_TARGET,
    REC_URGENT,
    REC_WAKE,
    REC_YIELD,
)

SCHEMA_NAME = "usf-trace"
SCHEMA_VERSION = 1

KIND_DECISIONS = "decisions"
KIND_WORKLOAD = "workload"


class TraceSchemaError(ValueError):
    pass


#: decision code <-> wire tag
CODE_TO_TAG = {
    REC_OP: "op",
    REC_SPAWN: "sp",
    REC_DISPATCH: "di",
    REC_BLOCK: "bl",
    REC_YIELD: "yi",
    REC_DONE: "dn",
    REC_PREEMPT: "pr",
    REC_WAKE: "wk",
    REC_JOB: "jb",
    REC_ATTACH: "at",
    REC_DEMOTE: "dm",
    REC_DETACH: "dt",
    REC_TARGET: "tg",
    REC_RESIZE: "rs",
    REC_DL_POST: "dp",
    REC_DL_RETIRE: "dr",
    REC_URGENT: "ur",
    REC_REQUEST: "rq",
    REC_REQ_DONE: "rd",
}
TAG_TO_CODE = {v: k for k, v in CODE_TO_TAG.items()}

#: body-op kind <-> wire tag (numeric-payload ops only; sync ops are never
#: recorded — the replayer reconstructs them from BLOCK/WAKE pairs)
_OP_TO_TAG = {
    "compute": "c",
    "stall": "st",
    "sleep": "s",
    "sleep_until": "su",
    "yield": "y",
    "checkpoint": "k",
}
_TAG_TO_OP = {v: k for k, v in _OP_TO_TAG.items()}


def encode_op(op: tuple) -> list:
    tag = _OP_TO_TAG.get(op[0])
    if tag is None:
        raise TraceSchemaError(f"unencodable op {op!r}")
    return [tag, *op[1:]]


def decode_op(arr: list) -> tuple:
    kind = _TAG_TO_OP.get(arr[0])
    if kind is None:
        raise TraceSchemaError(f"unknown op tag {arr[0]!r}")
    return (kind, *arr[1:])


def encode_record(rec: tuple) -> list:
    """(t, code, a, b) -> [tag, t, a, b]; op payloads are compacted."""
    t, code, a, b = rec
    tag = CODE_TO_TAG.get(code)
    if tag is None:
        raise TraceSchemaError(f"unknown decision code {code!r}")
    if code == REC_OP:
        b = encode_op(b)
    elif isinstance(b, tuple):
        b = list(b)
    return [tag, t, a, b]


def encode_record_json(rec: tuple) -> str:
    """One record straight to its JSONL line. Scalar-payload records —
    the hot dispatch/stop/wake stream, virtually all of a decisions-only
    trace — are formatted directly (several times cheaper than
    ``json.dumps``, which matters because the background writer encodes
    at the recording rate and competes with the traced run for the GIL);
    structured payloads fall back to ``encode_record`` + ``dumps``.
    ``repr`` of a float is its shortest exact form, which is also what
    ``json.dumps`` emits — decoded values are identical either way."""
    t, code, a, b = rec
    if type(a) is int and _isfinite(t):
        tb = type(b)
        if b is None or tb is int or (tb is float and _isfinite(b)):
            tag = CODE_TO_TAG.get(code)
            if tag is not None and code != REC_OP:
                return (f'["{tag}",{t!r},{a},'
                        f'{"null" if b is None else repr(b)}]')
    return json.dumps(encode_record(rec), separators=(",", ":"))


def decode_record(arr: list) -> tuple:
    if not isinstance(arr, list) or len(arr) != 4:
        raise TraceSchemaError(f"malformed record {arr!r}")
    tag, t, a, b = arr
    code = TAG_TO_CODE.get(tag)
    if code is None:
        raise TraceSchemaError(f"unknown record tag {tag!r}")
    if code == REC_OP:
        b = decode_op(b)
    elif isinstance(b, list):
        b = tuple(b)
    return (t, code, a, b)


def make_header(kind: str, meta: Optional[dict] = None) -> dict:
    return {
        "schema": SCHEMA_NAME,
        "version": SCHEMA_VERSION,
        "kind": kind,
        "meta": meta or {},
    }


def check_header(obj: Any) -> dict:
    if not isinstance(obj, dict):
        raise TraceSchemaError(f"trace header must be an object, got {obj!r}")
    if obj.get("schema") != SCHEMA_NAME:
        raise TraceSchemaError(
            f"not a {SCHEMA_NAME} trace (schema={obj.get('schema')!r})"
        )
    if obj.get("version") != SCHEMA_VERSION:
        raise TraceSchemaError(
            f"unsupported trace version {obj.get('version')!r} "
            f"(this reader speaks v{SCHEMA_VERSION})"
        )
    if obj.get("kind") not in (KIND_DECISIONS, KIND_WORKLOAD):
        raise TraceSchemaError(f"unknown trace kind {obj.get('kind')!r}")
    return obj


def write_trace(fh: TextIO, kind: str, lines: Iterable[list],
                meta: Optional[dict] = None) -> int:
    """Stream ``lines`` (already-encoded record arrays) to ``fh`` under a
    v1 header; returns the record count."""
    dump = json.dumps
    fh.write(dump(make_header(kind, meta), separators=(",", ":")) + "\n")
    n = 0
    for line in lines:
        fh.write(dump(line, separators=(",", ":")) + "\n")
        n += 1
    return n


def save_trace(path: str, kind: str, lines: Iterable[list],
               meta: Optional[dict] = None) -> int:
    with open(path, "w") as fh:
        return write_trace(fh, kind, lines, meta)


def iter_trace(source: Union[str, TextIO]) -> tuple[dict, Iterator[list]]:
    """Open a trace: returns (checked header, iterator of raw record
    arrays). Schema/version mismatches raise ``TraceSchemaError``."""
    fh = open(source) if isinstance(source, str) else source
    first = fh.readline()
    if not first.strip():
        raise TraceSchemaError("empty trace file")
    header = check_header(json.loads(first))

    def _lines():
        loads = json.loads
        with fh:
            for line in fh:
                if line.strip():
                    yield loads(line)

    return header, _lines()


def load_trace(source: Union[str, TextIO]) -> tuple[dict, list]:
    """Load a whole trace into memory: (header, decoded records) for a
    decisions trace, (header, raw arrays) for a workload trace."""
    header, lines = iter_trace(source)
    if header["kind"] == KIND_DECISIONS:
        return header, [decode_record(arr) for arr in lines]
    return header, list(lines)


def build_policy(desc):
    """(name, param) -> a fresh Policy instance (inverse of the recorder's
    ``_pol_desc``). ``None`` stays ``None`` (default group)."""
    if desc is None:
        return None
    name, param = desc
    from repro_torch.core.policies import SchedCoop, SchedFair, SchedRR

    if name == "SCHED_COOP":
        return SchedCoop(**({} if param is None else {"quantum": param}))
    if name == "SCHED_FAIR":
        return SchedFair(**({} if param is None else {"slice_s": param}))
    if name == "SCHED_RR":
        return SchedRR(**({} if param is None else {"quantum": param}))
    raise TraceSchemaError(f"unknown policy {name!r}")
