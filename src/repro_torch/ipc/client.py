"""BrokerClient — a worker process's side of the node-level lease broker.

Connects a process (typically one ``UsfRuntime``) to the ``NodeBroker``:
registers a share-weighted node lease, heartbeats for liveness, and
applies pushed grants. ``bind(runtime)`` wires grants straight into
elastic slot parking — a broker *revoke* shrinks the runtime's effective
width at its tasks' next scheduling points (within one tick period for
preemptive policies), a *grant* unparks and refills immediately.

Heartbeats are also the **demand channel** (envelope v2): every beat
piggybacks the worker's instantaneous runnable backlog — by default the
bound runtime's lock-free ``runnable_backlog()`` probe (READY + RUNNING
tasks), overridable with ``backlog_probe`` for workers whose demand
lives elsewhere (e.g. a server process folding in its request-queue
depth). The broker apportions over this live, hysteresis-damped demand
instead of the static registration width, so an idle process's slots
flow to a saturated sibling while the idle process stays alive and
registered. ``report_backlog=False`` restores the static (v1) contract.

Failure semantics (the paper's pure-user-space stance: coordination is an
optimization, never a liveness dependency — and since PR 6, the system
*heals*, it does not merely survive):

* losing the broker (EOF, send failure, reset) **degrades the worker to
  free-running immediately** — full local width, never a hang — and then
  runs a reconnect loop with exponential backoff + jitter. On reconnect
  the client re-registers under the same name/share/demand and resumes
  coordination: the failure is a transient
  ``COORDINATED → DEGRADED → RECONNECTING → COORDINATED`` state machine,
  not a terminal flag (``reconnect=False`` restores the PR 5 terminal
  degrade);
* lease ops on a lost broker raise a typed ``BrokerLostError`` — never a
  hang. The share change is still recorded locally and carried by the
  next re-registration (queued-or-rejected, at the caller's option);
* grants are **epoch-fenced**: every grant carries the broker's
  per-start ``incarnation`` and a monotonic ``epoch``; grants from a
  stale incarnation, or out-of-order within one, are dropped
  (``stale_grants_dropped``) — a grant racing a reconnect can never
  shrink this worker on a dead broker's authority;
* grants are floored at one slot when applied to a runtime, so a miserly
  apportionment can throttle a process but never starve it.
"""

from __future__ import annotations

import os
import random
import socket
import threading
import time
from typing import Callable, Iterator, Optional

from repro_torch.ipc import faults as _faults
from repro_torch.ipc.protocol import ProtocolError, recv_msg, send_msg


class BrokerLostError(ConnectionError):
    """A lease op reached a lost broker. Subclasses ``ConnectionError``
    (hence ``OSError``) so pre-typed callers keep working. Carries the
    client's failure-machine state at raise time."""

    def __init__(self, message: str, *, client: "BrokerClient" = None):
        super().__init__(message)
        self.client_name = None if client is None else client.name
        self.client_state = None if client is None else client.state
        self.degraded = False if client is None else client.degraded
        self.last_grant = None if client is None else client.granted


def backoff_delays(base: float = 0.05, cap: float = 2.0, *,
                   factor: float = 2.0, jitter: float = 0.5,
                   rng: Optional[random.Random] = None) -> Iterator[float]:
    """Exponential backoff with jitter: yields ``0`` first (immediate
    first attempt), then ``base``, ``base*factor``, … capped at ``cap``,
    each inflated by up to ``jitter`` uniformly — co-located workers
    reconnecting to a restarted broker must not stampede in lockstep."""
    rng = rng or random.Random()
    yield 0.0
    delay = base
    while True:
        yield delay * (1.0 + jitter * rng.random())
        delay = min(cap, delay * factor)


class BrokerClient:
    """One process's node-lease handle.

    Parameters
    ----------
    path:                the broker's Unix socket path.
    name:                worker name (diagnostics; broker snapshots).
    share:               node-lease share weight (default 1.0).
    slots:               demand — how many node slots this process can use
                         (default: the bound runtime's topology width, or 1).
    heartbeat_interval:  seconds between heartbeats (keep well under the
                         broker's ``heartbeat_timeout``).
    backlog_probe:       zero-arg callable returning this worker's current
                         runnable backlog (non-negative int), sampled at
                         every heartbeat. Default: the bound runtime's
                         ``runnable_backlog`` (set by ``bind``); without a
                         runtime or probe, beats carry no backlog and the
                         broker applies static (v1) demand.
    report_backlog:      ``False`` omits the backlog field even when a
                         probe is available — the static-demand contract.
    reconnect:           heal after a broker loss (default). ``False`` is
                         the legacy terminal degrade: free-running forever.
    reconnect_backoff:   ``(base, cap)`` seconds for the backoff helper.
    reconnect_timeout:   give up reconnecting after this many seconds of
                         one continuous outage (None: keep trying forever).
    on_grant:            callback ``(slots:int) -> None`` for pushed grants.
    on_disconnect:       callback ``() -> None`` when the broker is lost.
    on_reconnect:        callback ``() -> None`` after a successful rejoin.
    faults:              optional ``repro_torch.ipc.faults.FaultPlan`` wrapped
                         around this client's protocol send/recv layer.
    """

    #: failure-machine states
    CONNECTING = "connecting"
    COORDINATED = "coordinated"
    DEGRADED = "degraded"
    RECONNECTING = "reconnecting"
    STOPPED = "stopped"

    def __init__(self, path: str, *, name: str = "worker",
                 share: float = 1.0, slots: Optional[int] = None,
                 heartbeat_interval: float = 0.2,
                 backlog_probe: Optional[Callable[[], int]] = None,
                 report_backlog: bool = True,
                 reconnect: bool = True,
                 reconnect_backoff: tuple = (0.05, 2.0),
                 reconnect_timeout: Optional[float] = None,
                 on_grant: Optional[Callable[[int], None]] = None,
                 on_disconnect: Optional[Callable[[], None]] = None,
                 on_reconnect: Optional[Callable[[], None]] = None,
                 faults=None):
        self.path = path
        self.name = name
        self.share = float(share)
        self.slots = slots
        self.heartbeat_interval = float(heartbeat_interval)
        self.backlog_probe = backlog_probe
        self.report_backlog = bool(report_backlog)
        #: last backlog value a heartbeat actually carried (None before
        #: the first reporting beat, or when reporting is off)
        self.last_backlog: Optional[int] = None
        self.reconnect = bool(reconnect)
        self.reconnect_backoff = reconnect_backoff
        self.reconnect_timeout = reconnect_timeout
        self.on_grant = on_grant
        self.on_disconnect = on_disconnect
        self.on_reconnect = on_reconnect
        self._faults = faults
        self._rng = random.Random()
        self._runtime = None
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._io_thread: Optional[threading.Thread] = None
        self._beat_thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._first_grant = threading.Event()
        self.state = self.CONNECTING
        #: the last applied grant (node slots), None before the first one
        self.granted: Optional[int] = None
        #: monotonic fence within the adopted incarnation
        self.grant_epoch = 0
        #: the broker incarnation this client last coordinated under
        self.incarnation: Optional[str] = None
        self._conn_incarnation: Optional[str] = None
        #: True while the broker is lost (cleared by a successful rejoin)
        self.degraded = False
        self.connected = False
        #: lifetime counters (introspection / chaos assertions)
        self.outages = 0
        self.reconnects = 0
        self.stale_grants_dropped = 0

    # ------------------------------------------------------------------ #
    # wiring
    # ------------------------------------------------------------------ #
    def bind(self, runtime) -> "BrokerClient":
        """Wire grants into ``runtime`` (``UsfRuntime`` or ``SimExecutor`` —
        anything with ``set_slot_target``/``topology``): a pushed grant of
        ``n`` caps the runtime at ``max(1, n)`` slots; losing the broker
        restores the full topology (free-running degrade). Unless an
        explicit ``backlog_probe`` was given, heartbeats sample the
        runtime's lock-free ``runnable_backlog()`` as the live demand
        signal. Call before ``start()``."""
        self._runtime = runtime
        if self.slots is None:
            self.slots = runtime.topology.n_slots
        if self.backlog_probe is None:
            self.backlog_probe = getattr(runtime, "runnable_backlog", None)
        return self

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self, *, connect_timeout: float = 5.0) -> "BrokerClient":
        """Connect, register, and start the receiver/heartbeat threads.

        The initial connect retries with the same backoff helper the
        reconnect loop uses (a client racing broker startup — e.g. a
        gateway's server processes — settles instead of raising), bounded
        by the ``connect_timeout`` deadline; the last ``OSError`` is
        re-raised when the deadline passes."""
        if self._io_thread is not None:
            raise RuntimeError("client already started")
        deadline = time.monotonic() + float(connect_timeout)
        base, cap = self.reconnect_backoff
        last: Optional[OSError] = None
        for delay in backoff_delays(base, cap, rng=self._rng):
            if last is not None and time.monotonic() + delay >= deadline:
                raise last
            if self._stop_evt.wait(delay):
                raise BrokerLostError("client stopped during connect",
                                      client=self)
            try:
                self._connect_and_register(
                    attempt_timeout=max(0.1, deadline - time.monotonic()))
                break
            except OSError as e:
                last = e
        self.state = self.COORDINATED
        self._io_thread = threading.Thread(
            target=self._session_main, name=f"usf-broker-io-{self.name}",
            daemon=True)
        self._io_thread.start()
        self._beat_thread = threading.Thread(
            target=self._beat_main, name=f"usf-broker-beat-{self.name}",
            daemon=True)
        self._beat_thread.start()
        return self

    def stop(self, *, deregister: bool = True, timeout: float = 5.0) -> None:
        """Leave the broker cleanly (its lease is reclaimed for siblings)."""
        self._stop_evt.set()
        if deregister and self.connected:
            try:
                self._send({"op": "deregister"})
            except OSError:
                pass
        self._sever(self._sock)
        for t in (self._io_thread, self._beat_thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout)
        self.connected = False
        self.state = self.STOPPED

    # ------------------------------------------------------------------ #
    # lease ops (cross-process twins of SlotLease.resize / apply_rescale)
    # ------------------------------------------------------------------ #
    def resize(self, share: float) -> None:
        """Set this process's node share (elastic cross-process lease).

        On a lost broker this raises ``BrokerLostError`` — but the new
        share is already recorded locally, so the next re-registration
        carries it (queued-or-rejected, never a hang)."""
        self.share = float(share)
        self._send({"op": "resize", "share": self.share})

    def rescale(self, scale: float) -> None:
        """Multiply this process's node share by ``scale`` — the
        ``MeshRescaleEvent`` routing: a process that lost half its devices
        surrenders half its node-slot share to co-located processes. Same
        queued-or-rejected semantics as ``resize`` on a lost broker."""
        self.share *= float(scale)
        self._send({"op": "rescale", "scale": float(scale)})

    def wait_grant(self, timeout: Optional[float] = None) -> Optional[int]:
        """Block until the first grant is pushed; returns it (or None on
        timeout / after a degrade)."""
        self._first_grant.wait(timeout)
        return self.granted

    # ------------------------------------------------------------------ #
    # connection internals
    # ------------------------------------------------------------------ #
    def _connect_and_register(self, *, attempt_timeout: float = 1.0) -> None:
        """One connect + register attempt (start() and the reconnect loop
        both come through here). Raises ``OSError`` on failure."""
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(attempt_timeout)
        try:
            sock.connect(self.path)
        except OSError:
            sock.close()
            raise
        sock.settimeout(None)
        with self._send_lock:
            self._sock = sock
            self._conn_incarnation = None  # adopt the peer's on welcome
            try:
                self._raw_send(sock, {
                    "op": "register",
                    "name": self.name,
                    "share": self.share,
                    # explicit 0 is legal demand (the idle-worker fix); only an
                    # unset width defaults to 1
                    "slots": 1 if self.slots is None
                    else max(0, int(self.slots)),
                    "pid": os.getpid(),
                })
            except OSError:
                self._sock = None
                try:
                    sock.close()
                except OSError:
                    pass
                raise
        self.connected = True

    def _raw_send(self, sock: socket.socket, msg: dict) -> None:
        """Frame and send one message through the fault layer (caller
        holds ``_send_lock``)."""
        if self._faults is not None:
            act, delay = self._faults.send_action(msg)
            if delay > 0.0:
                time.sleep(delay)
            if act == _faults.DROP:
                return
            if act == _faults.TRUNCATE:
                try:
                    sock.sendall(_faults.truncated_frame())
                except OSError:
                    pass
                raise OSError("injected fault: truncated frame")
            if act == _faults.RESET:
                raise OSError("injected fault: connection reset")
        send_msg(sock, msg)

    def _send(self, msg: dict) -> None:
        sock = self._sock
        if sock is None or not self.connected:
            raise BrokerLostError(
                f"broker lost ({self.state}): {msg.get('op')} not delivered"
                " — lease state is queued for the next re-registration",
                client=self)
        try:
            with self._send_lock:
                self._raw_send(sock, msg)
        except OSError as e:
            # an intentional stop() must not masquerade as a broker loss:
            # no degrade, no reconnect, no width restore on a runtime that
            # is being torn down anyway
            if not self._stop_evt.is_set():
                self._sever(sock)  # the session thread runs the outage
            if isinstance(e, BrokerLostError):
                raise
            raise BrokerLostError(
                f"broker lost mid-send: {e}", client=self) from e

    def _sever(self, sock: Optional[socket.socket]) -> None:
        """Kill the current connection; the session thread's recv wakes
        with an error and drives the degrade/reconnect machinery."""
        if sock is None:
            return
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------------ #
    # the failure state machine (session thread)
    # ------------------------------------------------------------------ #
    def _session_main(self) -> None:
        while not self._stop_evt.is_set():
            self._recv_loop()
            if self._stop_evt.is_set():
                break
            self._on_outage()
            if not self.reconnect:
                # legacy terminal degrade: free-running forever
                self._stop_evt.set()
                break
            if not self._reconnect_loop():
                break

    def _recv_loop(self) -> None:
        """Serve one connection until it is lost (returns on loss)."""
        sock = self._sock
        if sock is None:
            return
        while not self._stop_evt.is_set():
            try:
                msg = recv_msg(sock)
            except (OSError, ProtocolError, ValueError):
                msg = None
            if msg is None:  # broker gone (EOF) or socket/stream error
                return
            if self._faults is not None:
                act, delay, msgs = self._faults.recv_actions(msg)
                if delay > 0.0:
                    time.sleep(delay)
                if act == _faults.RESET:
                    self._sever(sock)
                    return
                for m in msgs:
                    self._dispatch(m)
            else:
                self._dispatch(msg)

    def _dispatch(self, msg: dict) -> None:
        op = msg.get("op")
        if op == "welcome":
            self._adopt(msg.get("incarnation"), int(msg.get("epoch", 0)))
        elif op == "grant":
            inc = msg.get("incarnation")
            if inc is not None:
                if self._conn_incarnation is None:
                    # no welcome seen (dropped, or a pre-fencing broker):
                    # adopt the first grant's incarnation
                    self._adopt(inc, int(msg.get("epoch", 1)) - 1)
                elif inc != self._conn_incarnation:
                    # a dead broker's authority can never shrink us
                    self.stale_grants_dropped += 1
                    return
            epoch = int(msg.get("epoch", self.grant_epoch + 1))
            if epoch < self.grant_epoch:
                self.stale_grants_dropped += 1  # reordered: fence it
                return
            self.grant_epoch = epoch  # == is an idempotent refresh
            self.granted = int(msg["slots"])
            self._apply_grant(self.granted)
            self._first_grant.set()
        # snapshot replies and unknown ops are ignored (forward compat)

    def _adopt(self, incarnation: Optional[str], epoch: int) -> None:
        self._conn_incarnation = incarnation
        self.incarnation = incarnation
        self.grant_epoch = epoch

    def _on_outage(self) -> None:
        """Broker lost: degrade to free-running *immediately*; healing
        (or not, with ``reconnect=False``) happens after."""
        self.outages += 1
        self.connected = False
        self.degraded = True
        self.state = self.DEGRADED
        self._first_grant.set()  # unblock wait_grant callers
        if self._runtime is not None:
            try:
                self._runtime.set_slot_target(None)  # full width again
            except Exception:  # pragma: no cover - runtime already down
                pass
        if self.on_disconnect is not None:
            self.on_disconnect()

    def _reconnect_loop(self) -> bool:
        """Retry the broker with backoff + jitter until rejoined (True),
        stopped, or the ``reconnect_timeout`` outage budget is spent."""
        self.state = self.RECONNECTING
        base, cap = self.reconnect_backoff
        deadline = (None if self.reconnect_timeout is None
                    else time.monotonic() + self.reconnect_timeout)
        for delay in backoff_delays(base, cap, rng=self._rng):
            if deadline is not None and time.monotonic() + delay > deadline:
                self.state = self.DEGRADED  # outage budget spent: stay free
                self._stop_evt.set()
                return False
            if self._stop_evt.wait(delay):
                return False
            try:
                self._connect_and_register()
            except OSError:
                continue
            self.degraded = False
            self.state = self.COORDINATED
            self.reconnects += 1
            if self.on_reconnect is not None:
                self.on_reconnect()
            return True
        return False  # pragma: no cover - backoff iterator is infinite

    # ------------------------------------------------------------------ #
    # heartbeats
    # ------------------------------------------------------------------ #
    def _beat_main(self) -> None:
        while not self._stop_evt.wait(self.heartbeat_interval):
            if not self.connected:
                continue  # outage: the session thread is reconnecting
            if self._faults is not None and self._faults.stall_heartbeat():
                continue
            try:
                self._send(self._beat_msg())
            except OSError:
                continue  # loss is handled by the session thread

    def _beat_msg(self) -> dict:
        """One heartbeat, with the live backlog piggybacked (envelope v2)
        when a probe is available. A failing probe degrades THIS beat to
        v1 (no backlog field) — demand feedback is an optimization, never
        a liveness dependency, same as coordination itself."""
        msg = {"op": "heartbeat"}
        if self.report_backlog and self.backlog_probe is not None:
            try:
                backlog = max(0, int(self.backlog_probe()))
            except Exception:
                return msg
            self.last_backlog = backlog
            msg["backlog"] = backlog
        return msg

    def _apply_grant(self, slots: int) -> None:
        if self._runtime is not None:
            # liveness floor: a zero grant throttles to one slot, never to
            # a dead stop (the runtime applies the same floor)
            self._runtime.set_slot_target(max(1, slots))
        if self.on_grant is not None:
            self.on_grant(slots)

    def __enter__(self) -> "BrokerClient":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
