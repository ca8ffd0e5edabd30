"""A device trace over part of the window, and its reduction: the time
each kernel name ran, the union of the device's busy intervals, and the
longest gaps between them.

The profiler records device activity only (CUPTI kernels, copies and
sets), and is read from its raw events, so a window of some hundred
thousand launches reduces in seconds."""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Optional


class DeviceTrace:
    """Starts at ``start`` and stops at ``stop`` (host monotonic times),
    from a thread of its own."""

    def __init__(self, start: float, stop: float):
        self.start_at, self.stop_at = start, stop
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.events: list[tuple[str, int, int]] = []
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._main, daemon=True)

    def begin(self) -> None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("the device trace needs a CUDA card; there is none")
        self._thread.start()

    def join(self, timeout: float) -> None:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("the device trace did not stop")
        if self.error is not None:
            raise self.error

    def _main(self) -> None:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        try:
            time.sleep(max(0.0, self.start_at - time.monotonic()))
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            self.t0 = time.monotonic()
            time.sleep(max(0.0, self.stop_at - time.monotonic()))
            self.t1 = time.monotonic()
            prof.stop()
            raw = prof.profiler.kineto_results.events()
            self.events = [(e.name(), e.start_ns(), e.duration_ns()) for e in raw
                           if e.device_type() == DeviceType.CUDA]
        except BaseException as e:  # reported by join on the main thread
            self.error = e

    # ------------------------------------------------------------------ #
    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        return sum(b - a for a, b, _ in self._merged()) / 1e9

    def _merged(self) -> list[tuple[int, int, str]]:
        """Busy intervals (ns) with the name of the last kernel in each."""
        out: list[list] = []
        for name, s, d in sorted(self.events, key=lambda e: e[1]):
            if out and s <= out[-1][1]:
                if s + d > out[-1][1]:
                    out[-1][1], out[-1][2] = s + d, name
            else:
                out.append([s, s + d, name])
        return [tuple(x) for x in out]

    def by_name(self) -> dict[str, tuple[int, float]]:
        """{kernel name: (launches, device seconds)}."""
        acc: dict = defaultdict(lambda: [0, 0])
        for name, _, d in self.events:
            acc[name][0] += 1
            acc[name][1] += d
        return {k: (n, ns / 1e9) for k, (n, ns) in acc.items()}

    def launches(self, kernel: str) -> tuple[int, float]:
        """Launches and device seconds of the kernels whose names hold
        ``kernel`` (a template's name reads ``void kernel<...>(...)``)."""
        n = t = 0
        for name, (k, s) in self.by_name().items():
            if kernel in name:
                n, t = n + k, t + s
        return n, t

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((name[:160], s) for name, (_, s) in self.by_name().items()),
                     key=lambda x: -x[1])[:top]
        merged = self._merged()
        gaps = sorted(((f"after {merged[i][2][:150]}",
                        (merged[i + 1][0] - merged[i][1]) / 1e9)
                       for i in range(len(merged) - 1)), key=lambda x: -x[1])[:top]
        return {"device_ops": [list(x) for x in ops], "idle_gaps": [list(x) for x in gaps]}
