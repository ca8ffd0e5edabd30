"""Decision/event recorder: near-zero overhead disarmed, ring-buffered +
background-flushed when armed.

Disarmed cost by design:

* ``Scheduler`` hot paths pay exactly one predicate check
  (``self._rec is None``) per decision.
* ``SimExecutor`` op recording costs *nothing* disarmed — arming swaps
  ``_advance`` for its recording twin, so the plain advance loop carries
  no check at all (benchmarks/trace_replay.py measures the interleaved
  A/B at ~1.0x).

Armed, ``emit`` takes the one pre-built ``(t, code, a, b)`` tuple the hot
path hands it and appends it to a deque — ``emit`` IS ``deque.append``
(a C call, no Python frame at all), so the armed hot-path cost is one
tuple allocation + one C-level append per record in BOTH modes. With a
``path``, a daemon writer thread polls the ring on a short interval and
drains it in batches behind the run, streaming schema-encoded JSONL —
the producer never pays a ring-occupancy check, and drained records are
freed promptly so the allocator recycles them. Records are never
dropped — determinism diffs need the exact stream — so a producer
outrunning the disk grows the ring until the next poll instead of
losing records.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from repro_torch.trace import schema


class TraceRecorder:
    """Collects decision records from armed schedulers/executors.

    Parameters
    ----------
    path:       JSONL destination; ``None`` records in memory only.
    flush_at:   records per JSONL write batch in the background writer.
    poll_s:     background-writer drain interval (bounds ring occupancy
                at roughly ``producer rate x poll_s`` records).
    meta:       free-form dict stored in the trace header.
    """

    def __init__(self, path: Optional[str] = None, *,
                 flush_at: int = 8192, poll_s: float = 0.05,
                 meta: Optional[dict] = None):
        self.path = path
        self.meta = dict(meta or {})
        self._ring: deque = deque()
        self._flush_at = flush_at
        self._poll_s = poll_s
        self.emitted = 0
        self._armed: list = []  # (kind, target) pairs for detach_all
        self._fh = None
        self._writer: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._closing = False
        # `emit` takes ONE pre-built record tuple and IS the ring deque's
        # C-level append — no Python frame, no occupancy check, in either
        # mode. The file-mode writer drains by polling (`poll_s`), so the
        # producer's cost never depends on ring state.
        self.emit = self._ring.append
        if path is not None:
            self._fh = open(path, "w")
            self._fh.write(__import__("json").dumps(
                schema.make_header(schema.KIND_DECISIONS, self.meta),
                separators=(",", ":")) + "\n")
            self._writer = threading.Thread(target=self._drain_loop,
                                            name="trace-writer", daemon=True)
            self._writer.start()

    # ------------------------------------------------------------------ #
    # arm / disarm
    # ------------------------------------------------------------------ #
    def attach_sim(self, sim, *, ops: bool = True) -> "TraceRecorder":
        """Arm a ``SimExecutor``: decision hooks on its scheduler and —
        with ``ops`` — the intrinsic-op recording twin on the engine
        (required for a replayable recording; decisions-only is enough
        for monitoring). Arm before ``run``."""
        sim.sched._rec = self.emit
        if ops:
            sim._set_op_recorder(self.emit)
        self._armed.append(("sim", sim))
        return self

    def attach_runtime(self, rt) -> "TraceRecorder":
        """Arm a live ``UsfRuntime`` (decision records; real-thread bodies
        are opaque, so op recording does not apply)."""
        rt.set_recorder(self.emit)
        self._armed.append(("runtime", rt))
        return self

    def attach_sched(self, sched) -> "TraceRecorder":
        sched._rec = self.emit
        self._armed.append(("sched", sched))
        return self

    def detach_all(self) -> None:
        for kind, target in self._armed:
            if kind == "sim":
                target.sched._rec = None
                target._set_op_recorder(None)
            elif kind == "runtime":
                target.set_recorder(None)
            else:
                target._rec = None
        self._armed.clear()

    # ------------------------------------------------------------------ #
    # results
    # ------------------------------------------------------------------ #
    def records(self) -> list:
        """The in-memory stream (order preserved). With a ``path`` this is
        only the not-yet-flushed tail — use the file for the full trace."""
        return list(self._ring)

    def close(self) -> "TraceRecorder":
        """Detach everything and flush/close the file (if any)."""
        self.detach_all()
        if self._writer is not None:
            self._closing = True
            self._wake.set()
            self._writer.join()
            self._writer = None
        if self._fh is not None:
            self._flush_ring()
            self._fh.close()
            self._fh = None
        return self

    def __enter__(self) -> "TraceRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # background writer
    # ------------------------------------------------------------------ #
    def _drain_loop(self) -> None:
        while True:
            self._wake.wait(timeout=self._poll_s)
            self._wake.clear()
            self._flush_ring()
            if self._closing:
                return

    def _flush_ring(self) -> None:
        ring = self._ring
        fh = self._fh
        if fh is None:
            return
        encode = schema.encode_record_json
        popleft = ring.popleft
        out = []
        while ring:
            try:
                out.append(encode(popleft()))
            except IndexError:  # pragma: no cover - producer raced us
                break
            if len(out) >= self._flush_at:
                fh.write("\n".join(out) + "\n")
                self.emitted += len(out)
                out = []
        if out:
            fh.write("\n".join(out) + "\n")
            self.emitted += len(out)
