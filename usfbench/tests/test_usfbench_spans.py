"""The program's spans joined to the device trace (``usfbench/spantrace.py``):
the clock conversion, the attribution of idle time to the span the running
task had open, the named gaps and ``idle_by_span``, the span metrics'
readers, ``span_probe.py`` at smoke size, and on the card a span around a
known kernel that must enclose the kernel's converted interval."""

import json
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from usfbench import spantrace
from usfbench.harness import load_metric
from usfbench.trace import DeviceTrace

torch.set_num_threads(min(2, torch.get_num_threads()))

OFF = 1_760_000_000_000_000_000  # Unix minus monotonic ns in the synthetic traces
MS = 1_000_000


def _trace(t0, t1, busy, drift_ns=0):
    """A ClockedTrace over [t0, t1) (monotonic s) whose events are ``busy``
    ((name, start s, end s) on the monotonic clock), read through pairs at
    t0 and t1 whose offset moves by ``drift_ns``."""
    tr = spantrace.ClockedTrace(t0, t1)
    tr.t0, tr.t1 = t0, t1
    m0, m1 = round(t0 * 1e9), round(t1 * 1e9)
    tr.pairs = [(m0, m0 + OFF), (m1, m1 + OFF + drift_ns)]
    tr.events = [(name, round(a * 1e9) + OFF, round((b - a) * 1e9)) for name, a, b in busy]
    return tr


# trainer0 (tid 1) holds the one slot until it yields at 10.40; trainer1
# (tid 2) runs from 10.45 and blocks at 10.75; no task runs after
BUSY = [("k1", 10.0, 10.2), ("k2", 10.5, 10.6), ("k3", 10.89, 10.95)]
RECORDS = [(9.0, 2, 1, 0), (10.40, 4, 1, 0), (10.45, 2, 2, 0), (10.75, 3, 2, 0),
           (10.76, 7, 2, None)]
SPANS = [
    (9.6, 10.3, "train.dispatch", 1, ("trainer0", 1), None),
    (10.3, 10.39, "train.sync", 1, ("trainer0", 1), None),
    (9.5, 10.39, "train.step", 1, ("trainer0", 1), None),
    (9.0, 10.46, "train.yield", 2, ("trainer1", 0), None),
    (10.39, 10.5, "train.yield", 1, ("trainer0", 1), None),
    (10.46, 10.55, "train.loader", 2, ("trainer1", 1), None),
    (10.55, 10.7, "train.dispatch", 2, ("trainer1", 1), None),
    (10.46, 10.7, "train.step", 2, ("trainer1", 1), None),
]
WANT = {("trainer0", "train.dispatch"): 0.10, ("trainer0", "train.sync"): 0.09,
        ("trainer0", "train.yield"): 0.01, (None, "no task"): 0.05 + 0.14 + 0.05,
        ("trainer1", "train.yield"): 0.01, ("trainer1", "train.loader"): 0.04,
        ("trainer1", "train.dispatch"): 0.10, ("trainer1", "no span"): 0.05}


def test_clock_pairs_convert_with_the_interpolated_offset():
    tr = _trace(10.0, 12.0, [("k", 11.0, 11.5)], drift_ns=2000)
    assert tr.offsets_ns() == [OFF, OFF + 2000]
    assert tr.to_monotonic(10_000_000_000 + OFF) == pytest.approx(10.0, abs=1e-9)
    # halfway in Unix time, half the drift
    assert tr.to_monotonic(11_000_000_000 + OFF + 1000) == pytest.approx(11.0, abs=1e-9)
    (a, b, name), = tr.busy()
    assert name == "k" and a == pytest.approx(11.0 - 1e-6, abs=1e-9)
    m, u = spantrace.clock_pair()
    assert abs((u - m) - (time.time_ns() - time.monotonic_ns())) < 5 * MS


def test_idle_goes_to_the_running_tasks_innermost_span():
    tr = _trace(10.0, 11.0, BUSY)
    got = spantrace.idle_by_label(tr, SPANS, RECORDS)
    assert set(got) == set(WANT)
    for k, v in WANT.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k
    assert sum(got.values()) == pytest.approx(tr.window_s - tr.busy_s(), abs=1e-9)


def test_tasks_running_on_two_slots_share_an_idle_piece():
    tr = _trace(0.0, 1.0, [])
    records = [(0.0, 2, 1, 0), (0.0, 2, 2, 1), (0.5, 4, 2, 1)]
    spans = [(0.0, 1.0, "engine.step", 1, ("server0", 0), 3),
             (0.0, 1.0, "engine.sync", 2, ("server1", 0), None)]
    got = spantrace.idle_by_label(tr, spans, records)
    assert got[("server0", "engine.step")] == pytest.approx(0.75)
    assert got[("server1", "engine.sync")] == pytest.approx(0.25)


def test_breakdown_names_gaps_by_job_and_span():
    tr = _trace(10.0, 11.0, BUSY)
    plain = tr.breakdown()
    got = spantrace.breakdown(tr, SPANS, RECORDS)
    assert got["device_ops"] == plain["device_ops"]
    assert [g[1] for g in got["idle_gaps"]] == [g[1] for g in plain["idle_gaps"]]
    assert got["idle_gaps"][0] == ["trainer0:train.dispatch after k1", pytest.approx(0.3)]
    assert got["idle_gaps"][1] == ["no task after k2", pytest.approx(0.29)]
    # a gap after the interval, recorded while the profiler stops
    tr.events.append(("k4", round(11.3 * 1e9) + OFF, round(0.01 * 1e9)))
    assert spantrace.breakdown(tr, SPANS, RECORDS)["idle_gaps"][0] == [
        "outside the trace after k3", pytest.approx(0.35)]
    assert [k for k, _ in got["idle_by_span"]] == [
        "no task", "train.dispatch", "train.sync", "no span", "train.loader", "train.yield"]
    assert got["idle_by_span"][1][1] == pytest.approx(0.2)


def test_breakdown_without_spans_is_the_traces_own():
    tr = _trace(0.0, 1.0, [("flash_fwd_tma_wgmma", 0.0, 0.1), ("gemm", 0.05, 0.15),
                           ("gemm", 0.4, 0.5), ("flash_fwd_tma_wgmma", 0.9, 0.95)])
    got = spantrace.breakdown(tr, [], [])
    assert got == DeviceTrace.breakdown(tr)
    assert got["idle_gaps"][0] == ["after gemm", pytest.approx(0.4)]
    assert "idle_by_span" not in got


def _ctx(**kw):
    jobs = {"train": ["trainer0"], "serve": []}
    jobs.update(kw.pop("jobs", {}))
    ctx = types.SimpleNamespace(t_w0=0.0, t_w1=10.0, trace=None,
                                traffic=types.SimpleNamespace(loop="none"),
                                jobs_of=lambda kind: jobs[kind])
    for k, v in kw.items():
        setattr(ctx, k, v)
    return ctx


def test_readers_of_the_train_spans():
    spans = [(0.5, 0.6, "train.dispatch", 1, ("trainer0", 1), None),
             (0.6, 1.0, "train.sync", 1, ("trainer0", 1), None),
             (1.05, 1.25, "train.dispatch", 2, ("trainer1", 1), None),
             (1.25, 3.0, "train.sync", 2, ("trainer1", 1), None),
             (3.2, 3.5, "train.dispatch", 1, ("trainer0", 2), None),
             (9.9, 10.5, "train.dispatch", 2, ("trainer1", 2), None)]
    ctx = _ctx(spans=spans, records=[])
    # dispatches of 0.1, 0.2 and 0.3 s end in the window; one ends after it
    assert load_metric("dispatch_ms.train").read(ctx) == pytest.approx(200.0)
    # syncs end at 1.0 and 3.0; the next dispatches start at 1.05 and 3.2
    assert load_metric("turnaround_ms.train").read(ctx) == pytest.approx(125.0)
    tr = _trace(10.0, 11.0, BUSY)
    ctx = _ctx(spans=SPANS, records=RECORDS, trace=tr)
    assert load_metric("idle_in_dispatch_share.train").read(ctx) == pytest.approx(20.0)


def test_readers_of_the_engine_spans():
    spans = [(1.0 + i, 1.0 + i + d, name, 5, ("server0", i), None)
             for i, (name, d) in enumerate([("engine.dispatch", 0.01), ("engine.sync", 0.3),
                                            ("engine.dispatch", 0.03), ("engine.sync", 0.5),
                                            ("engine.dispatch", 0.02)])]
    ctx = _ctx(spans=spans, jobs={"serve": ["server0"]})
    ctx.traffic.loop = "open"
    assert load_metric("engine_dispatch_ms.open").read(ctx) == pytest.approx(20.0)
    assert load_metric("engine_sync_ms.open").read(ctx) == pytest.approx(400.0)


@pytest.mark.parametrize("name", ["dispatch_ms.train", "turnaround_ms.train",
                                  "idle_in_dispatch_share.train", "engine_dispatch_ms.open",
                                  "engine_sync_ms.open"])
def test_span_readers_read_nothing_from_a_run_without_spans(name):
    """A run whose harness arms nothing (its context has no ``spans``),
    even with a plain trace: nothing, not 0."""
    ctx = _ctx(jobs={"serve": ["server0"]}, trace=DeviceTrace(0.0, 1.0))
    ctx.traffic.loop = "open"
    assert load_metric(name).read(ctx) is None


def test_span_probe_at_smoke_size(monkeypatch):
    """The probe's armed run of the training cell on the CPU, with a stub
    in the profiler's place (the trace's thread, clock pairs and window,
    no device events): every trainer's step and yield spans cover its
    traced time, and the span metrics read."""
    from usfbench import span_probe
    from usfbench_smoke import smoke_overrides

    def stub(self):
        self.t0 = time.monotonic()
        time.sleep(max(0.0, self.stop_at - time.monotonic()))
        self.t1 = time.monotonic()

    monkeypatch.setattr(DeviceTrace, "_main", stub)
    monkeypatch.setattr(spantrace.ClockedTrace, "begin", lambda self: self._thread.start())
    workload = "smollm-360m.train-pair"
    over = smoke_overrides(workload)
    over["cell"]["trace"] = {"start_frac": 0.5, "seconds": 1.0}
    out = span_probe.probe(workload, 2 ** 33 + 7, 3.0, "cpu", overrides=over)
    m = out["metrics"]
    assert m["dispatch_ms.train"] > 0 and m["turnaround_ms.train"] > 0
    assert 0 < m["idle_in_dispatch_share.train"] <= 100
    assert sorted(out["coverage"]) == ["trainer0", "trainer1"]
    assert all(c > 0.9 for c in out["coverage"].values()), out["coverage"]
    assert out["breakdown"]["idle_by_span"]
    off = span_probe.probe(workload, 2 ** 33 + 7, 2.0, "cpu", armed=False, overrides=over)
    assert off["train_tok_s"] > 0 and "metrics" not in off


#: the card marker, run in a fresh interpreter as the benchmark runs: the
#: profiler on a thread of its own, the span and the kernel on the main one
MARKER = r"""
import json, sys, time
sys.path[:0] = sys.argv[1:3]
import torch
from usfbench import spantrace
torch.cuda._sleep(1000)
torch.cuda.synchronize()
start = time.monotonic() + 0.3
tr = spantrace.ClockedTrace(start, start + 1.0)
tr.begin()
time.sleep(0.6)
a = time.monotonic()
torch.cuda._sleep(20_000_000)  # ~10 ms at the card's clock
torch.cuda.synchronize()
b = time.monotonic()
tr.join(timeout=60.0)
name, s, d = max(tr.events, key=lambda e: e[2])
print(json.dumps({"name": name, "a": a, "b": b, "k0": tr.to_monotonic(s),
                  "k1": tr.to_monotonic(s + d), "offsets": tr.offsets_ns()}))
"""


@pytest.mark.gpu
def test_span_encloses_its_kernel_on_the_card():
    """A span around ``torch.cuda._sleep`` and a synchronise encloses the
    sleep kernel's interval, converted to the monotonic clock, to within
    0.2 ms at both ends. In a fresh interpreter: in pytest's own process
    Kineto printed "External init callback must run in same thread as
    registerClient" and recorded no device event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = Path(__file__).resolve().parents[2]
    proc = subprocess.run([sys.executable, "-c", MARKER, str(root / "src"), str(root)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    m = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"kernel {m['name'][:40]!r}: {1e3 * (m['k1'] - m['k0']):.3f} ms; span start to "
          f"kernel start {1e3 * (m['k0'] - m['a']):.4f} ms, kernel end to span end "
          f"{1e3 * (m['b'] - m['k1']):.4f} ms; offsets {m['offsets']} ns")
    assert m["a"] - 2e-4 <= m["k0"] and m["k1"] <= m["b"] + 2e-4
