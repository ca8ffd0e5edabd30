"""Multi-process serving — N server *processes* behind one gateway, on torch.

Port of ``repro/serve/multiproc.py`` with the same supervision and
coordination behaviour. The single-process engine
(``repro_torch.serve.engine``) co-locates servers as jobs inside one
``UsfRuntime``; this module is the paper's full *multi-process* story: each
model server runs in its own OS process with its own runtime, and the
processes share the node's slots through the node-level lease broker
(``repro_torch.ipc``) instead of blind OS-level oversubscription:

    gateway process: MultiProcessGateway ── NodeBroker (thread)
        ├── ServerProcess A: UsfRuntime + BrokerClient + InferenceServer
        ├── ServerProcess B: …
        └── ServerProcess C: …

Request fan-out/fan-in crosses process boundaries over multiprocessing
queues; *slot* coordination crosses them over the broker's Unix socket.
Each server registers a nice-derived (or explicit) node share, so the
paper's gateway-nice-0 / servers-nice-20 priority story scales from jobs
to processes unchanged.

Failure/recovery (``supervise=True``, the default): the gateway
*supervises* its server processes — a dead ``ServerProcess`` is restarted
with capped exponential backoff, a crash loop (more than ``max_restarts``
deaths inside ``restart_window`` seconds) opens a circuit breaker that
marks the slot failed (surfaced in ``snapshot()``) while requests keep
routing to the survivors, and a request in flight on a dying server is
retried once on a survivor before a ``ServerProcessError`` surfaces.
``supervise=False`` is the fail-fast behaviour: a dead server raises at the
caller and stays dead. Either way a dead server's node lease is reclaimed
by the broker and a dead broker degrades every server to free-running —
then heals once a broker is back on the rendezvous path.

Differences from the JAX module, all in how the device is driven:

* the child builds the port's engine (``repro_torch.serve.engine``);
* the spec carries ``device``, a string so that it pickles: ``None`` means
  the CUDA card, as it does for ``InferenceServer``. A child that finds no
  card raises, and the traceback reaches the parent as
  ``ServerProcessError``; it never carries on on the CPU;
* on the CPU the child pins torch to one intra-op thread before it builds
  the model, so that the runtime's slots are the only parallelism;
* the child's standard output goes to its standard error: the parent's
  standard output is the parent's alone;
* the gateway spawns all its server processes before it waits for the
  first to be ready, so that their model builds (seconds each on the card)
  overlap;
* each response also carries the server's engine steps and the launch
  counts of the port's kernel wrappers in the child, both cumulative since
  the child started, and ``handle`` returns them by server (``steps``,
  ``launches``), so that a caller can see each child's decode go through
  the kernels.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import threading
import time
from typing import Any, Optional

from repro_torch.ipc import BrokerClient, NodeBroker

#: spawn, not fork: a server child initialises its own CUDA context (a
#: forked child would inherit the parent's, which CUDA does not support)
_CTX = mp.get_context("spawn")


class ServerProcessError(RuntimeError):
    pass


def _kernel_launches() -> dict:
    """This process's launch count of each kernel wrapper of the port."""
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     moe_gmm, rglru_scan, ssd_scan)

    return {f.__name__: f.launches for f in (
        decode_attention.flash_decode, flash_attention.flash_attention_fwd,
        moe_gmm.moe_gmm, ssd_scan.ssd_scan, rglru_scan.rglru_scan)}


def _server_main(spec: dict, req_q, resp_q) -> None:
    """Child entry: one InferenceServer on its own broker-bound runtime."""
    try:
        os.dup2(2, 1)  # nothing of the child reaches the parent's stdout
        import torch

        from repro_torch.configs.base import get_arch, get_smoke
        from repro_torch.core.policies import SchedCoop
        from repro_torch.core.threads import UsfRuntime
        from repro_torch.core.topology import Topology
        from repro_torch.models.base import resolve_device
        from repro_torch.serve.engine import InferenceServer, Request

        device = resolve_device(spec.get("device"))  # raises without a card
        if device.type == "cpu":
            torch.set_num_threads(1)
        usf = UsfRuntime(Topology(int(spec["slots"]), 1), SchedCoop())
        client = None
        if spec.get("broker_path"):
            share = spec.get("share")

            def _backlog() -> int:
                # real demand, not topology width: the runtime's runnable
                # tasks plus the gateway requests still queued toward this
                # server — an idle server reports 0 and its node slots
                # flow to a saturated sibling process
                try:
                    queued = req_q.qsize()
                except (NotImplementedError, OSError):
                    queued = 0  # qsize is unsupported on some platforms
                return usf.runnable_backlog() + queued

            client = BrokerClient(
                spec["broker_path"],
                name=spec["name"],
                # explicit 0.0 is a valid (best-effort) share: only an
                # unset share defaults to 1.0
                share=1.0 if share is None else share,
                heartbeat_interval=spec.get("heartbeat_interval", 0.2),
                backlog_probe=_backlog,
            ).bind(usf).start()
            client.wait_grant(5.0)  # coordinated before the first decode
        cfg = (get_smoke(spec["arch"]) if spec.get("smoke", True)
               else get_arch(spec["arch"]))
        server = InferenceServer(
            spec["name"], cfg, usf,
            max_batch=int(spec.get("max_batch", 2)),
            max_len=int(spec.get("max_len", 32)),
            nice=int(spec.get("nice", 0)),
            share=spec.get("job_share"),
            # auto-checkpointed decode (default): a broker regrant parks
            # this server's surplus slots within ~one engine step even
            # while it is decode-saturated, instead of waiting for the
            # batch to drain to a blocking point
            auto_ckpt=bool(spec.get("auto_ckpt", True)),
            device=device,
        )
        server.start()
        resp_q.put({"ready": True, "pid": os.getpid(), "device": str(device)})
        while True:
            item = req_q.get()
            if item is None:
                break
            rid, tokens, max_new = item
            req = server.submit(Request(tokens=list(tokens),
                                        max_new=int(max_new)))
            # the pump is a plain-thread waiter on the CoopEvent (mixed
            # waiters are supported); the decode loop runs gated
            req.done.wait()
            resp_q.put({
                "rid": rid,
                "output": list(req.output),
                "latency": req.latency,
                "granted": None if client is None else client.granted,
                "steps": server.steps,
                "launches": _kernel_launches(),
            })
        server.stop()
        if client is not None:
            client.stop()
        usf.shutdown(timeout=5.0)
    except Exception:  # noqa: BLE001 - surface to the parent, then die
        import traceback

        resp_q.put({"fatal": traceback.format_exc()})
        raise


class ServerProcess:
    """Parent-side handle of one model-server process.

    Restartable: ``restart()`` respawns a dead child on *fresh* queues
    (in-flight items on the old queues die with the old process) and
    bumps ``generation`` so a caller blocked on the old response stream
    surfaces a ``ServerProcessError`` instead of waiting on a queue
    nobody will ever fill. ``failed`` is the crash-loop circuit breaker
    flag (set by the supervising gateway, surfaced in snapshots).

    ``device`` (a string, or None for the CUDA card) is where the child
    builds and runs its model."""

    def __init__(self, name: str, arch: str, *,
                 broker_path: Optional[str] = None,
                 slots: int = 2, share: Optional[float] = None,
                 nice: int = 0, max_batch: int = 2, max_len: int = 32,
                 smoke: bool = True, heartbeat_interval: float = 0.2,
                 auto_ckpt: bool = True, device: Optional[str] = None):
        self.name = name
        self.spec = {
            "name": name,
            "arch": arch,
            "broker_path": broker_path,
            "slots": slots,
            "share": share,
            "job_share": None,
            "nice": nice,
            "max_batch": max_batch,
            "max_len": max_len,
            "smoke": smoke,
            "heartbeat_interval": heartbeat_interval,
            "auto_ckpt": auto_ckpt,
            "device": None if device is None else str(device),
        }
        self._req_q = _CTX.Queue()
        self._resp_q = _CTX.Queue()
        self._proc: Optional[Any] = None
        self._rid = 0
        self.served = 0
        #: bumped on every (re)spawn; result() fences on it
        self.generation = 0
        #: lifetime restarts performed on this slot
        self.restarts = 0
        #: circuit breaker: True once the slot crash-looped and was
        #: permanently benched (requests route to survivors only)
        self.failed = False
        #: monotonic stamps of observed deaths (the breaker's window)
        self.fail_times: list = []

    def start(self, *, ready_timeout: float = 180.0) -> "ServerProcess":
        self._spawn()
        return self._await_ready(ready_timeout)

    def _spawn(self) -> None:
        self._proc = _CTX.Process(
            target=_server_main,
            args=(self.spec, self._req_q, self._resp_q),
            name=f"usf-server-{self.name}", daemon=True)
        self._proc.start()

    def _await_ready(self, ready_timeout: float) -> "ServerProcess":
        msg = self._next_resp(ready_timeout)
        if not msg.get("ready"):
            raise ServerProcessError(f"{self.name} failed to start: {msg}")
        return self

    def restart(self, *, ready_timeout: float = 180.0) -> "ServerProcess":
        """Respawn a dead server on fresh queues (supervision path)."""
        old = self._proc
        if old is not None and old.is_alive():
            raise ServerProcessError(f"{self.name} is alive; not restarting")
        if old is not None:
            old.join(0.0)
        self._req_q = _CTX.Queue()
        self._resp_q = _CTX.Queue()
        self.generation += 1
        self.restarts += 1
        return self.start(ready_timeout=ready_timeout)

    @property
    def pid(self) -> Optional[int]:
        return None if self._proc is None else self._proc.pid

    def alive(self) -> bool:
        return self._proc is not None and self._proc.is_alive()

    def submit(self, tokens, max_new: int = 4) -> int:
        """Queue one request; returns its rid (responses arrive FIFO)."""
        self._rid += 1
        self._req_q.put((self._rid, list(tokens), max_new))
        return self._rid

    def result(self, timeout: Optional[float] = None) -> dict:
        """Next response (FIFO — the server pump is serial)."""
        msg = self._next_resp(timeout)
        self.served += 1
        return msg

    def _next_resp(self, timeout: Optional[float]) -> dict:
        deadline = None if timeout is None else time.monotonic() + timeout
        gen = self.generation
        resp_q = self._resp_q
        while True:
            step = 0.5 if deadline is None else max(
                0.0, min(0.5, deadline - time.monotonic()))
            try:
                msg = resp_q.get(timeout=step)
            except queue_mod.Empty:
                if self.generation != gen:
                    # the supervisor restarted the child under us: the
                    # old response stream is dead, surface it
                    raise ServerProcessError(
                        f"server process {self.name} restarted mid-request")
                if not self.alive():
                    raise ServerProcessError(
                        f"server process {self.name} (pid={self.pid}) died")
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"no response from {self.name} within {timeout}s")
                continue
            if "fatal" in msg:
                raise ServerProcessError(
                    f"{self.name} crashed:\n{msg['fatal']}")
            return msg

    def stop(self, timeout: float = 10.0) -> None:
        if self._proc is None:
            return
        try:
            self._req_q.put(None)
        except (OSError, ValueError):
            pass
        self._proc.join(timeout)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(5.0)


class MultiProcessGateway:
    """Fans each request out to every live server process and joins the
    responses (the cross-process twin of ``serve.engine.Gateway``).

    With ``coordinate=True`` (default) the gateway hosts the designated
    ``NodeBroker`` thread and every server process registers with it —
    the co-located servers split the node by share instead of
    oversubscribing it. ``coordinate=False`` is the free-running baseline:
    same processes, no slot coordination.

    With ``supervise=True`` (default) the gateway is *self-healing*: a
    supervisor thread restarts dead servers with capped exponential
    backoff (``restart_backoff``), opens a crash-loop circuit breaker
    after ``max_restarts`` deaths within ``restart_window`` seconds
    (slot marked ``failed``, surfaced by ``snapshot()``, routed around),
    and ``handle`` retries a request lost to a dying server once on a
    survivor. ``supervise=False`` is the fail-fast behaviour.

    ``device`` (a string, or None for the CUDA card) is passed to every
    server process.
    """

    def __init__(self, archs: dict[str, str], *, coordinate: bool = True,
                 node_capacity: Optional[int] = None,
                 slots_per_server: int = 2, shares: Optional[dict] = None,
                 max_batch: int = 2, max_len: int = 32, smoke: bool = True,
                 heartbeat_timeout: float = 1.0,
                 supervise: bool = True, max_restarts: int = 3,
                 restart_window: float = 30.0,
                 restart_backoff: tuple = (0.5, 8.0),
                 poll_interval: float = 0.2,
                 device: Optional[str] = None):
        self.broker: Optional[NodeBroker] = None
        broker_path = None
        if coordinate:
            self.broker = NodeBroker(capacity=node_capacity,
                                     heartbeat_timeout=heartbeat_timeout)
            broker_path = self.broker.start()
        shares = shares or {}
        self.servers = [
            ServerProcess(name, arch, broker_path=broker_path,
                          slots=slots_per_server, share=shares.get(name),
                          max_batch=max_batch, max_len=max_len, smoke=smoke,
                          device=device)
            for name, arch in archs.items()
        ]
        self.supervise = bool(supervise)
        self.max_restarts = int(max_restarts)
        self.restart_window = float(restart_window)
        self.restart_backoff = restart_backoff
        self._poll_interval = float(poll_interval)
        self._ready_timeout = 180.0
        self._stop_evt = threading.Event()
        self._supervisor: Optional[threading.Thread] = None
        self.responses: list[dict] = []

    def start(self, *, ready_timeout: float = 180.0) -> "MultiProcessGateway":
        self._ready_timeout = float(ready_timeout)
        for s in self.servers:
            s._spawn()
        for s in self.servers:
            s._await_ready(ready_timeout)
        if self.supervise:
            self._supervisor = threading.Thread(
                target=self._supervise_main, name="usf-gateway-supervisor",
                daemon=True)
            self._supervisor.start()
        return self

    # ------------------------------------------------------------------ #
    # supervision (restart + crash-loop circuit breaker)
    # ------------------------------------------------------------------ #
    def _supervise_main(self) -> None:
        while not self._stop_evt.wait(self._poll_interval):
            for s in self.servers:
                if s.failed or s._proc is None or s.alive():
                    continue
                now = time.monotonic()
                s.fail_times.append(now)
                s.fail_times[:] = [t for t in s.fail_times
                                   if now - t <= self.restart_window]
                if len(s.fail_times) > self.max_restarts:
                    # crash loop: open the breaker — stop burning the
                    # node respawning it, keep routing to survivors
                    s.failed = True
                    continue
                base, cap = self.restart_backoff
                delay = min(cap, base * (2 ** (len(s.fail_times) - 1)))
                if self._stop_evt.wait(delay):
                    return
                try:
                    s.restart(ready_timeout=self._ready_timeout)
                except Exception:  # noqa: BLE001
                    # the respawn itself crashed (e.g. still-broken
                    # config): the dead child is counted at the next
                    # poll, converging on the breaker
                    pass

    def _targets(self) -> list:
        if not self.supervise:
            return list(self.servers)
        return [s for s in self.servers if not s.failed and s.alive()]

    def handle(self, tokens, max_new: int = 4,
               timeout: Optional[float] = None) -> dict:
        """Submit to every live server process, wait for all responses.

        Under supervision, a request lost to a dying server is retried
        once on a surviving server before ``ServerProcessError``
        surfaces; the stand-in's answer is recorded under the dead
        server's key with a ``retried_on`` marker."""
        t0 = time.monotonic()
        targets = self._targets()
        if not targets:
            raise ServerProcessError("no live server processes")

        def left() -> Optional[float]:
            return None if timeout is None else max(
                0.0, timeout - (time.monotonic() - t0))

        for s in targets:
            s.submit(tokens, max_new)
        per_server = {}
        dead = []
        for s in targets:
            try:
                per_server[s.name] = s.result(timeout=left())
            except ServerProcessError:
                if not self.supervise:
                    raise
                dead.append(s)
        for s in dead:
            survivors = [t for t in targets
                         if t is not s and t.name in per_server and t.alive()]
            if not survivors:
                raise ServerProcessError(
                    f"{s.name} died mid-request and no survivor could "
                    "retry it")
            stand_in = survivors[0]
            stand_in.submit(tokens, max_new)
            retried = dict(stand_in.result(timeout=left()))
            retried["retried_on"] = stand_in.name
            per_server[s.name] = retried
        rec = {
            "latency": time.monotonic() - t0,
            "per_server": {n: r["latency"] for n, r in per_server.items()},
            "outputs": {n: r["output"] for n, r in per_server.items()},
            "retried": {n: r["retried_on"] for n, r in per_server.items()
                        if "retried_on" in r},
            "steps": {n: r["steps"] for n, r in per_server.items()},
            "launches": {n: r["launches"] for n, r in per_server.items()},
        }
        self.responses.append(rec)
        return rec

    def snapshot(self) -> dict:
        """Supervision + coordination state: per-server liveness,
        restart counts, breaker flags — and the broker's lease table."""
        out = {
            "supervise": self.supervise,
            "servers": {
                s.name: {
                    "alive": s.alive(),
                    "pid": s.pid,
                    "restarts": s.restarts,
                    "failed": s.failed,
                    "served": s.served,
                } for s in self.servers
            },
        }
        if self.broker is not None:
            out["broker"] = self.broker.snapshot()
        return out

    def stop(self) -> None:
        self._stop_evt.set()
        if self._supervisor is not None:
            self._supervisor.join(10.0)
        for s in self.servers:
            s.stop()
        if self.broker is not None:
            self.broker.stop()

    def __enter__(self) -> "MultiProcessGateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
