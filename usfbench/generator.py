"""The one traffic generator. A mix file (``traffic/<name>.json``) gives
its parameters: ``loop`` ("open": arrivals at a fixed rate, each request
sent when it is due whatever the backlog; "none": no requests), and the
prompt and output lengths (lognormal, by median and sigma, clipped to
[min, max]). The cell file gives the rate.

Every seed gets the same requests, (prompt, output) pairs of the
quantiles of the two length distributions paired in one fixed order, and
the same gaps between arrivals, the quantiles of the exponential; the seed
draws the order of both and the prompts' token ids. So seeds change which
request comes when, not how much work a window holds.

Each request is sent by a gateway client task of its own, created at its
due time, and timed from its due time to the join of its fan-out."""

from __future__ import annotations

import statistics
import time
from typing import Optional

import numpy as np


class Sent:
    """One request as the benchmark saw it."""

    __slots__ = ("prompt", "max_new", "due", "done_at", "outputs", "error", "task")

    def __init__(self, prompt: list, max_new: int, due: float):
        self.prompt = prompt
        self.max_new = max_new
        self.due = due
        self.done_at: Optional[float] = None
        self.outputs: Optional[dict] = None
        self.error: Optional[str] = None
        self.task = None

    @property
    def latency(self) -> Optional[float]:
        return None if self.done_at is None else self.done_at - self.due


def _quantiles(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    z = [statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    return np.clip(np.rint(median * np.exp(sigma * np.asarray(z))), lo, hi).astype(int)


#: the seed of the one pairing of prompt with output lengths, the same
#: for every run
PAIRING_SEED = 20_261_018


def draw(mix: dict, n: int, rng: np.random.Generator, vocab: int) -> list[tuple]:
    """n (prompt, max_new) pairs: the lengths' quantiles, paired in a fixed
    order, sent in a seeded order."""
    p, o = mix["prompt"], mix["output"]
    plen = _quantiles(n, p["median"], p["sigma"], p["min"], p["max"])
    olen = np.random.default_rng(PAIRING_SEED).permutation(
        _quantiles(n, o["median"], o["sigma"], o["min"], o["max"]))
    return [(rng.integers(0, vocab, size=int(plen[i])).tolist(), int(olen[i]))
            for i in rng.permutation(n)]


def arrival_offsets(rate: float, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """Due times in [0, seconds): Poisson gaps, as the quantiles of the
    exponential distribution in a seeded order."""
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    t = np.cumsum(rng.permutation(gaps)) - gaps.min()
    return t[t < seconds]


class Traffic:
    def __init__(self, mix: dict, cell_traffic: dict, *, usf, gateway, vocab: int,
                 rng: np.random.Generator):
        self.mix = mix
        self.cell = cell_traffic
        self.usf = usf
        self.gw = gateway
        self.vocab = vocab
        self.rng = rng
        self.sent: list[Sent] = []
        self.lateness: list[float] = []

    @property
    def loop(self) -> str:
        return self.mix["loop"]

    # ------------------------------------------------------------------ #
    def _client(self, s: Sent, timeout: float) -> None:
        try:
            rec = self.gw.handle(s.prompt, max_new=s.max_new, timeout=timeout)
        except TimeoutError as e:
            s.error = str(e)
            return
        s.done_at = time.monotonic()
        s.outputs = rec["outputs"]

    def _spawn(self, s: Sent, timeout: float) -> None:
        s.task = self.usf.create(self._client, (s, timeout), job=self.gw.job,
                                 name="client")

    def warm(self, n: int, timeout: float) -> None:
        """``n`` requests of the mix's shortest prompt and output, one at a
        time, through the whole path; before the window."""
        p, o = self.mix["prompt"], self.mix["output"]
        for _ in range(n):
            s = Sent(self.rng.integers(0, self.vocab, size=p["min"]).tolist(),
                     o["min"], time.monotonic())
            self._spawn(s, timeout)
            if not self.usf.join(s.task, timeout=timeout) or s.done_at is None:
                raise RuntimeError(f"a warm-up request took over {timeout} s")

    def run(self, t0: float, t1: float, drain_deadline: float) -> None:
        """Send the window's requests; returns at ``t1``."""
        if self.loop == "open":
            offs = arrival_offsets(self.cell["rate_per_s"], t1 - t0, self.rng)
            reqs = draw(self.mix, len(offs), self.rng, self.vocab)
            for off, (prompt, n) in zip(offs, reqs):
                due = t0 + float(off)
                wait = due - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                s = Sent(prompt, n, due)
                self.lateness.append(time.monotonic() - due)
                self.sent.append(s)
                self._spawn(s, drain_deadline - time.monotonic())
        elif self.loop != "none":
            raise ValueError(f"unknown loop {self.loop!r}")
        wait = t1 - time.monotonic()
        if wait > 0:
            time.sleep(wait)

    def drain(self, deadline: float) -> None:
        """Wait for the requests in flight, until ``deadline`` at most."""
        for s in list(self.sent):
            if s.task is not None:
                s.task._done_event.wait(max(0.0, deadline - time.monotonic()))

    # ------------------------------------------------------------------ #
    def due_in(self, t0: float, t1: float) -> list[Sent]:
        return [s for s in self.sent if t0 <= s.due < t1]


def percentile(values: list[float], pct: int) -> float:
    """The ``pct``-th percentile (linear between order statistics)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[pct - 1]


def overlap_rate(intervals: list[tuple], t0: float, t1: float) -> float:
    """Units a second over [t0, t1) of (start, end, units) intervals, each
    counted by the share of its own length that lies in the window."""
    got = 0.0
    for a, b, units in intervals:
        inside = max(0.0, min(b, t1) - max(a, t0))
        if b > a:
            got += units * inside / (b - a)
    return got / (t1 - t0)

