"""One run of one cell: set-up, the measured window, the drain, the check
against the plain reference, and the metrics.

Everything a cell is made of is found by name: the cell file
``cells/<workload>.json`` (its jobs, runtime, rate, drain limit, check
sample and limits), the configuration ``configs/<config>.json``, the mix
``traffic/<traffic>.json``, each job kind ``jobs/<kind>.py`` and each
metric ``metrics/<name>.py`` (a ``read(ctx)`` that returns a number or
None). BENCHMARK.json says which metrics a cell reports. A cell that is
not in BENCHMARK.json yet carries the entries it would add under its
file's ``benchmark`` key (``benchmark_with``), so that the knee sweep and
the control readings can run it."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import statistics
import threading
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from usfbench import generator
from usfbench.trace import DeviceTrace
from usfbench.weights import make_params

HERE = Path(__file__).resolve().parent

#: configuration file keys and the port's ArchConfig fields they set
ARCH_FIELDS = {
    "hidden_size": "d_model", "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff", "vocab_size": "vocab", "head_dim": "head_dim",
    "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings", "param_dtype": "param_dtype",
    "compute_dtype": "compute_dtype",
}


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def program_arch(conf: dict):
    """The port's ArchConfig of the family ``conf["program_arch"]`` names,
    with every size the file gives."""
    from repro_torch.configs.base import get_arch

    return dataclasses.replace(get_arch(conf["program_arch"]),
                               **{f: conf[k] for k, f in ARCH_FIELDS.items()})


def load_metric(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("usfbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_with(bench: dict, workload: str) -> dict:
    """BENCHMARK.json's ``bench``, with ``workload`` added from its cell
    file's ``benchmark`` entries where BENCHMARK.json does not hold it: its
    workload entry, its new metrics, and its name in the ``workloads`` list
    of each metric it reports that BENCHMARK.json already has."""
    if any(w["name"] == workload for w in bench["workloads"]):
        return bench
    extra = read_json(HERE / "cells" / f"{workload}.json")["benchmark"]
    out = json.loads(json.dumps(bench))
    out["workloads"].append(dict(extra["workload"]))
    for section in ("end_to_end", "per_layer"):
        for m in out[section]:
            if m["name"] in extra["metrics"] and "workloads" in m:
                m["workloads"].append(workload)
        out[section] += [dict(m, workloads=[workload]) for m in extra["new_metrics"][section]]
    return out


def cell_metrics(bench: dict, workload: str, section: str) -> list[dict]:
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def ready_wait(task) -> float:
    """A task's READY seconds so far, the current stretch included."""
    from repro_torch.core.task import TaskState

    w = task.stats.wait_time
    if task.state is TaskState.READY:
        w += time.monotonic() - task._ready_at
    return w


class Context:
    """What a run knows: its files, its seed, its program objects and what
    it read at the window's edges. Job kinds and metric readers read it."""

    def __init__(self, workload: str, *, seed: int, seconds: float, trace: bool,
                 device, bench: dict, t_proc0: float, overrides: Optional[dict] = None):
        w = next(c for c in bench["workloads"] if c["name"] == workload)
        self.bench = bench
        self.workload = w
        self.cell = read_json(HERE / "cells" / f"{workload}.json")
        self.conf = read_json(HERE / "configs" / f"{w['config']}.json")
        self.mix = read_json(HERE / "traffic" / f"{w['traffic']}.json")
        for key, value in (overrides or {}).items():  # smoke sizes in tests
            getattr(self, key).update(value)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace_on = bool(trace)
        self.device = torch.device(device)
        self.t_proc0 = t_proc0
        self.arch = program_arch(self.conf)
        self.rng_traffic = np.random.default_rng(self._ss("traffic"))
        self.rng_check = np.random.default_rng(self._ss("check"))
        self.stop_training = threading.Event()
        self.jobs: list = []
        self.usf = None
        self.gateway = None
        self.traffic = None
        self.trace: Optional[DeviceTrace] = None
        self.t_w0 = self.t_w1 = self.t_drained = None
        self.edges: list[dict] = []

    def _ss(self, tag: str, index: int = 0) -> np.random.SeedSequence:
        return np.random.SeedSequence([self.seed % 2 ** 64, zlib.crc32(tag.encode()), index])

    def seed_for(self, tag: str, index: int) -> int:
        """A 63-bit seed for one job's weights or data, from the run's seed."""
        return int(self._ss(tag, index).generate_state(1, np.uint64)[0] >> np.uint64(1))

    def make_params(self, seed: int) -> dict:
        from repro_torch.models.registry import build_model

        return make_params(build_model(self.arch).param_specs(), self.arch.param_dtype,
                           seed, self.device, self.conf["initializer_range"])

    @property
    def window_s(self) -> float:
        return self.t_w1 - self.t_w0

    def jobs_of(self, kind: str) -> list:
        return [j for j in self.jobs if j.kind == kind]

    def edge_delta(self, job, key: str) -> float:
        i = self.jobs.index(job)
        return self.edges[1][i][key] - self.edges[0][i][key]

    def _edge(self) -> list[dict]:
        return [dict(j.counters(), wait=sum(ready_wait(t) for t in j.tasks()))
                for j in self.jobs]


def _runtime(spec: dict):
    from repro_torch.core.policies import SchedCoop
    from repro_torch.core.threads import UsfRuntime
    from repro_torch.core.topology import Topology

    return UsfRuntime(Topology(spec["slots"], spec.get("domains", 1)),
                      SchedCoop(quantum=spec["quantum_s"]))


def setup(ctx: Context) -> None:
    """Build the cell's jobs on a fresh runtime, start them, send the
    warm-up requests and wait until every job is ready (the trainers'
    checked steps done)."""
    from repro_torch.serve.engine import Gateway

    cell = ctx.cell
    ctx.usf = usf = _runtime(cell["runtime"])
    for spec in cell["jobs"]:
        kind = importlib.import_module(f"usfbench.jobs.{spec['kind']}")
        for _ in range(spec.get("count", 1)):
            ctx.jobs.append(kind.Job(ctx, spec, len(ctx.jobs_of(spec["kind"]))))
    for j in ctx.jobs:
        j.build(usf)
    servers = [j.server for j in ctx.jobs_of("serve")]
    if servers:
        ctx.gateway = Gateway(usf, servers, share=cell["runtime"].get("gateway_share"))
    ctx.traffic = generator.Traffic(ctx.mix, cell.get("traffic", {}), usf=usf,
                                    gateway=ctx.gateway, vocab=ctx.conf["vocab_size"],
                                    rng=ctx.rng_traffic)
    for j in ctx.jobs:
        j.start()
    if servers:
        ctx.traffic.warm(cell["traffic"]["warmup_requests"], cell["setup_limit_s"])
    limit = time.monotonic() + cell["setup_limit_s"]
    while not all(j.ready() for j in ctx.jobs):
        if time.monotonic() > limit:
            raise RuntimeError("set-up did not finish within its limit")
        time.sleep(0.01)


def window(ctx: Context, log=print) -> None:
    """The measured window, the counters at its edges, the trace within
    it, and the drain of the requests in flight at its close."""
    cell = ctx.cell
    ctx.t_w0 = t0 = time.monotonic()
    ctx.edges = [ctx._edge()]
    t1 = t0 + ctx.seconds
    drain_deadline = t1 + cell.get("traffic", {}).get("drain_s", 0.0)
    if ctx.trace_on:  # a start_frac of 1 traces after the window, untaxed by the profiler
        tr = cell["trace"]
        start = t0 + tr["start_frac"] * ctx.seconds
        ctx.trace = DeviceTrace(start, start + tr["seconds"])
        ctx.trace.begin()
    ctx.traffic.run(t0, t1, drain_deadline)
    ctx.t_w1 = time.monotonic()
    ctx.edges.append(ctx._edge())
    log(f"window {ctx.window_s:.3f} s; set-up {ctx.t_w0 - ctx.t_proc0:.3f} s")
    ctx.traffic.drain(drain_deadline)
    ctx.t_drained = time.monotonic()
    if ctx.trace is not None:
        ctx.trace.join(timeout=120.0)


def stop(ctx: Context) -> int:
    """Stop every job and the runtime, read the memory peak, and free the
    program's state. Returns the peak (bytes; 0 off the card)."""
    usf = ctx.usf
    try:
        ctx.stop_training.set()
        for j in ctx.jobs_of("train"):
            if not usf.join(j.task, timeout=ctx.cell["stop_limit_s"]):
                raise RuntimeError(f"{j.name} did not stop")
        for j in ctx.jobs_of("serve"):
            j.stop()
            if not usf.join(j.server._task, timeout=ctx.cell["stop_limit_s"]):
                raise RuntimeError(f"{j.name} did not stop")
    finally:
        ctx.stop_training.set()
        usf.shutdown()
    on_card = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    for j in ctx.jobs:
        j.free()
    ctx.gateway = None
    ctx.usf = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return peak


def checks(ctx: Context, log=print) -> dict:
    """Each number compared, with its limit: the worst over the jobs. A
    number the cell gives no limit is a reading, logged and not compared."""
    numbers: dict[str, float] = {}
    for j in ctx.jobs:
        for k, v in j.check(ctx).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    limits = ctx.cell["limits"]
    for k in sorted(set(numbers) - set(limits)):
        log(f"reading {k}: {numbers[k]!r} (not compared)")
    out = {k: {"value": v, "limit": limits[k]} for k, v in sorted(numbers.items())
           if k in limits}
    never = [s for s in ctx.traffic.due_in(ctx.t_w0, ctx.t_w1) if s.done_at is None]
    out["unanswered"] = {"value": len(never), "limit": 0}
    return out


def run_cell(ctx: Context, log=print) -> dict:
    """Run the cell of ``ctx``; returns the result line's object."""
    try:
        setup(ctx)
        window(ctx, log)
    except BaseException:
        if ctx.usf is not None:
            ctx.stop_training.set()
            ctx.usf.shutdown()
        raise
    peak = stop(ctx)
    checked = checks(ctx, log)
    correct = all(c["value"] <= c["limit"] for c in checked.values())

    section = "per_layer" if ctx.trace_on else "end_to_end"
    metrics = {}
    for m in cell_metrics(ctx.bench, ctx.workload["name"], section):
        value = load_metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    due = ctx.traffic.due_in(ctx.t_w0, ctx.t_w1)
    trains = sum(len(j.intervals) for j in ctx.jobs_of("train"))
    on_card = ctx.device.type == "cuda"
    device = {"platform": "gpu" if on_card else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct,
           "attempted": len(due) if ctx.traffic.loop != "none" else trains,
           "failed": checked["unanswered"]["value"], "metrics": metrics, "device": device}
    if ctx.trace is not None:
        device["busy_s"] = ctx.trace.busy_s()
        device["window_s"] = ctx.trace.window_s
        out["breakdown"] = ctx.trace.breakdown()
    lat = [s.latency for s in due if s.latency is not None]
    if lat:
        log(f"requests due {len(due)}, answered {len(lat)}, latency median "
            f"{statistics.median(lat):.4f} s max {max(lat):.4f} s; generator "
            f"lateness max {max(ctx.traffic.lateness, default=0.0):.4f} s")
    for j in ctx.jobs_of("train"):
        log(f"{j.name}: {len(j.intervals)} steps, median "
            f"{statistics.median(b - a for a, b, _ in j.intervals):.4f} s")
    steps = [iv for j in ctx.jobs_of("train") for iv in j.intervals]
    if ctx.trace is not None and steps:  # what the profiler costs the trainers
        log(f"training tokens/s: window {generator.overlap_rate(steps, ctx.t_w0, ctx.t_w1):.1f}, "
            f"traced {generator.overlap_rate(steps, ctx.trace.t0, ctx.trace.t1):.1f}")
    out["checks"] = checked
    return out
