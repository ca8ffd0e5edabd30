"""NodeBroker — the node-level lease broker (cross-process USF).

One broker per node apportions the node's slots across *processes*, the
same way the in-process ``SlotArbiter`` apportions one scheduler's slots
across jobs — literally with the same machinery (``repro_torch.core.lease``):

* every registered worker process holds a node lease: a share weight
  apportioned into an integer ``quota`` by largest remainder;
* grants are **work-conserving**: capacity a worker cannot use (its
  demand is below its quota) is redistributed to wanting workers in the
  I5 borrow order (least-over-quota first), so no node slot idles while
  a sibling process has demand;
* demand is **live** (envelope v2): each heartbeat piggybacks the
  worker's instantaneous runnable backlog, and apportionment runs over
  ``effective want = clamp(backlog, 0, registered width)`` instead of
  the static registration width — an idle worker's slots flow to a
  saturated sibling while the idle process is still alive and
  registered. Demand swings are **hysteresis-damped** per worker
  (``DemandState``: K consecutive beats on the same side of the current
  effective want, an EWMA smoother, and a minimum re-grant interval), so
  a bursty backlog cannot flap grants across the node. A zero backlog is
  a legal demand (``want=0`` likewise at registration): the broker can
  grant a worker nothing — the liveness floor lives at grant
  *application* (``BrokerClient`` floors ``set_slot_target`` at one
  slot), not in the demand model. Workers that never report backlog (v1
  clients) keep the static contract: effective want == registered width;
* leases are **elastic**: ``resize``/``rescale`` ops re-apportion at
  runtime (the cross-process twin of ``SlotLease.resize``, and the
  landing point of ``MeshRescaleEvent`` routing);
* liveness is **heartbeat-based**: a worker that dies abruptly is
  detected by socket EOF (immediate) or by missed heartbeats (wedged
  process with an open socket) and its lease is reclaimed — the
  survivors' grants grow within one reaping pass;
* grants are **fenced**: every broker start mints a fresh ``incarnation``
  id, carried on the ``welcome`` handshake and on every grant alongside
  the monotonic grant ``epoch``. Clients drop grants from a stale
  (incarnation, epoch) pair, so a grant racing a reconnect can never act
  on a dead broker's authority. A restarted broker takes over the
  rendezvous path (stale socket files are probed and reclaimed) and
  rebuilds its lease table purely from the workers' re-registrations;
* delivery is **self-healing**: the current grant also rides every
  heartbeat ack, so a lost grant push heals within one heartbeat
  interval, and a heartbeat from an unregistered connection (its
  ``register`` was lost) drops the connection — the worker's reconnect
  loop re-registers it.

The broker runs as a thread in a designated process (``NodeBroker(...).
start()``) or standalone (``python -m repro_torch.ipc.broker``). It needs no
special permissions: rendezvous is a Unix-domain socket in a user-writable
path. Workers connect through ``repro_torch.ipc.client.BrokerClient``, whose
grants land on ``UsfRuntime.set_slot_target`` (elastic slot parking); a
dead broker degrades every worker to free-running — coordination is an
optimization, never a liveness dependency.
"""

from __future__ import annotations

import argparse
import itertools
import os
import selectors
import socket
import threading
import time
from typing import Optional

from repro_torch.core.lease import LeaseTable, borrow_order
from repro_torch.ipc.protocol import (
    FrameDecoder,
    ProtocolError,
    default_socket_path,
    send_msg,
)

_WID = itertools.count()


class BrokerError(RuntimeError):
    pass


class DemandState:
    """Hysteresis-damped live-demand tracker for one worker.

    Pure and deterministic — no wall-clock reads, no randomness: the
    caller supplies ``now`` with every observation, so the same beat
    sequence always yields the same decision sequence (pinned by the
    seeded determinism tests in tests/test_chaos.py).

    ``observe(backlog, now)`` folds one heartbeat's backlog sample into
    the model and returns the new effective want when the damping admits
    a move, else ``None``. The damping has three gates, all of which must
    open:

    * **side hysteresis** — the clamped sample must land on the same side
      of the current effective want for ``beats`` consecutive
      observations (a sample *at* the effective want resets the streak:
      the grant already matches demand);
    * **EWMA smoothing** — the admitted target is the smoothed backlog
      (``alpha``-weighted), clamped into [0, width] and nudged at least
      one step in the confirmed direction so a laggy average cannot veto
      a confirmed move;
    * **min-regrant interval** — at most one move per ``min_interval``
      seconds, so even a persistent sawtooth regrants boundedly.

    ``width`` is the registered demand ceiling (the worker's topology
    width); effective want always stays in [0, width]. Zero is a legal
    resting state — the model can express "this process wants nothing".
    """

    __slots__ = ("width", "eff", "ewma", "beats", "alpha", "min_interval",
                 "_side", "_streak", "_last_change", "last_backlog")

    def __init__(self, width: int, *, beats: int = 3, alpha: float = 0.5,
                 min_interval: float = 0.25):
        self.width = max(0, int(width))
        self.eff = self.width          # static until live feedback arrives
        self.ewma = float(self.eff)
        self.beats = max(1, int(beats))
        self.alpha = float(alpha)
        self.min_interval = float(min_interval)
        self._side = 0
        self._streak = 0
        self._last_change = float("-inf")
        #: last raw (clamped) sample, for introspection/snapshots
        self.last_backlog: Optional[int] = None

    def set_width(self, width: int) -> None:
        """Re-registration / resize moved the demand ceiling. A worker
        that has never reported backlog (v1 client) keeps the static
        contract — effective want tracks the new width; one with live
        feedback is clamped into the new range."""
        self.width = max(0, int(width))
        if self.last_backlog is None:
            self.eff = self.width
            self.ewma = float(self.width)
        else:
            if self.eff > self.width:
                self.eff = self.width
            self.ewma = min(self.ewma, float(self.width))

    def observe(self, backlog: int, now: float) -> Optional[int]:
        b = min(max(0, int(backlog)), self.width)
        self.last_backlog = b
        self.ewma += self.alpha * (b - self.ewma)
        side = (b > self.eff) - (b < self.eff)
        if side == 0:
            self._side = 0
            self._streak = 0
            return None
        self._streak = self._streak + 1 if side == self._side else 1
        self._side = side
        if self._streak < self.beats:
            return None
        if now - self._last_change < self.min_interval:
            return None
        target = min(max(0, int(round(self.ewma))), self.width)
        # a confirmed move must advance at least one slot even while the
        # EWMA still straddles the old value
        target = max(target, self.eff + 1) if side > 0 \
            else min(target, self.eff - 1)
        target = min(max(0, target), self.width)
        self.eff = target
        self._last_change = now
        self._side = 0
        self._streak = 0
        return target


class ProcLease:
    """One registered worker process's claim on the node's slots.

    A ``LeaseTable`` entry (``share``/``quota``/``in_use``), plus the
    broker-side connection state. ``want`` is the worker's *registered*
    demand ceiling (its own topology width; 0 is legal — a pure
    best-effort process); ``demand`` tracks its *live* effective want
    from heartbeat backlog feedback (static ``== want`` for v1 clients
    that never report backlog). ``granted`` is the pushed allotment —
    ``in_use`` mirrors it so the shared I5 borrow order applies
    unchanged. ``last_pushed`` remembers the grant content last sent on
    this connection, so an unchanged regrant is suppressed instead of
    re-pushed.
    """

    __slots__ = ("wid", "name", "pid", "share", "quota", "in_use", "want",
                 "granted", "last_beat", "conn", "demand", "last_pushed")

    def __init__(self, wid: int, name: str, pid: int, share: float,
                 want: int, conn: socket.socket, demand: DemandState):
        self.wid = wid
        self.name = name
        self.pid = pid
        self.share = share
        self.quota = 0
        self.in_use = 0
        self.want = want
        self.granted = 0
        self.last_beat = time.monotonic()
        self.conn = conn
        self.demand = demand
        #: (granted, quota) of the last successful push on this conn
        self.last_pushed: Optional[tuple] = None

    @property
    def eff_want(self) -> int:
        """The demand the apportionment sees: hysteresis-damped live
        backlog, clamped into [0, registered width]."""
        return self.demand.eff

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"ProcLease({self.name}#{self.wid} pid={self.pid} "
                f"share={self.share:.1f} {self.granted}/{self.quota} "
                f"want={self.eff_want}/{self.want})")


class NodeBroker:
    """Node-level slot broker over a Unix-domain socket.

    Parameters
    ----------
    path:               rendezvous socket path (default: per-user tmp path).
    capacity:           node slots to apportion (default: ``os.cpu_count()``).
    heartbeat_timeout:  seconds of silence before a worker is declared dead
                        and its lease reclaimed (socket EOF reclaims
                        immediately; this catches wedged-but-open workers).
    demand_beats:       hysteresis depth K — a worker's effective want
                        moves only after K consecutive heartbeats whose
                        backlog lands on the same side of it (flap
                        damping; see ``DemandState``).
    demand_alpha:       EWMA weight for the backlog smoother (1.0 = raw
                        samples, smaller = smoother).
    min_regrant_interval: per-worker floor (seconds) between demand-driven
                        effective-want moves — even a persistent backlog
                        sawtooth regrants boundedly.
    """

    def __init__(self, path: Optional[str] = None, *,
                 capacity: Optional[int] = None,
                 heartbeat_timeout: float = 1.0,
                 demand_beats: int = 3, demand_alpha: float = 0.5,
                 min_regrant_interval: float = 0.25):
        self.path = path or default_socket_path()
        self.capacity = int(capacity if capacity is not None
                            else (os.cpu_count() or 1))
        if self.capacity <= 0:
            raise BrokerError(f"capacity must be positive, got {self.capacity}")
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.demand_beats = int(demand_beats)
        self.demand_alpha = float(demand_alpha)
        self.min_regrant_interval = float(min_regrant_interval)
        #: per-start incarnation id: the fencing token carried on every
        #: grant — a restarted broker can never be mistaken for its
        #: predecessor by a reconnecting client
        self.incarnation = f"{os.getpid():x}.{os.urandom(6).hex()}"
        self._table = LeaseTable(self.capacity)
        self._lock = threading.Lock()
        self._sel: Optional[selectors.BaseSelector] = None
        self._listener: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        #: connections whose grant push failed mid-_regrant (wedged or
        #: gone); dropped by the serve loop OUTSIDE the table lock —
        #: _drop -> _regrant from inside _regrant would deadlock
        self._dead_conns: list[socket.socket] = []
        self._epoch = 0
        #: lifetime counters (introspection / tests)
        self.registrations = 0
        self.reclaims = 0
        #: regrant passes run (any trigger: membership, share, demand)
        self.regrants = 0
        #: regrant passes triggered by a damped demand swing specifically
        self.demand_regrants = 0
        #: grant messages actually pushed by regrant passes
        self.grants_pushed = 0
        #: per-worker sends a regrant pass skipped because the grant
        #: content was unchanged (the dedupe the flap-damping test pins)
        self.grants_suppressed = 0

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> str:
        """Bind the socket and serve from a daemon thread; returns the
        rendezvous path (pass it to the workers' ``BrokerClient``)."""
        self._bind()
        self._thread = threading.Thread(
            target=self._serve, name="usf-node-broker", daemon=True
        )
        self._thread.start()
        return self.path

    def serve_forever(self) -> None:
        """Blocking variant (standalone broker process)."""
        self._bind()
        self._serve()

    def _bind(self) -> None:
        if self._listener is not None:
            raise BrokerError("broker already started")
        if os.path.exists(self.path):
            # never hijack a LIVE broker on a shared rendezvous path (the
            # per-user default): probe it — only a stale socket left by a
            # dead broker may be unlinked and rebound
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            probe.settimeout(0.5)
            try:
                probe.connect(self.path)
            except OSError:
                pass  # nobody listening: stale file, safe to reclaim
            else:
                raise BrokerError(
                    f"a broker is already serving {self.path}; connect a "
                    "BrokerClient to it or pick another path")
            finally:
                probe.close()
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
        lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        lst.bind(self.path)
        lst.listen(64)
        lst.setblocking(False)
        self._listener = lst
        self._sel = selectors.DefaultSelector()
        self._sel.register(lst, selectors.EVENT_READ, None)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._cleanup()

    def _cleanup(self) -> None:
        with self._lock:
            for lease in list(self._table.values()):
                try:
                    lease.conn.close()
                except OSError:
                    pass
            self._table.entries.clear()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        if self._sel is not None:
            self._sel.close()
            self._sel = None
        try:
            os.unlink(self.path)
        except OSError:
            pass

    # ------------------------------------------------------------------ #
    # event loop
    # ------------------------------------------------------------------ #
    def _serve(self) -> None:
        sel = self._sel
        poll = min(0.05, self.heartbeat_timeout / 4)
        try:
            while not self._stop_evt.is_set():
                for key, _ in sel.select(timeout=poll):
                    if key.data is None:
                        self._accept()
                    else:
                        self._service(key.fileobj, key.data)
                self._reap_stale()
                self._flush_dead()
        finally:
            self._cleanup()

    def _accept(self) -> None:
        try:
            conn, _ = self._listener.accept()
        except OSError:
            return
        conn.setblocking(False)
        # registered with data=[lease-or-None]: the first message on the
        # connection must be `register`, which fills the cell in
        self._sel.register(conn, selectors.EVENT_READ, [None, FrameDecoder()])

    def _service(self, conn: socket.socket, cell: list) -> None:
        lease: Optional[ProcLease] = cell[0]
        decoder: FrameDecoder = cell[1]
        try:
            data = conn.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            # EOF / reset: a killed worker process lands here — reclaim
            # its lease immediately (faster than the heartbeat timeout)
            self._drop(conn, cell, reclaim=True)
            return
        try:
            msgs = decoder.feed(data)
        except (ProtocolError, ValueError):
            self._drop(conn, cell, reclaim=True)
            return
        for msg in msgs:
            try:
                self._handle(conn, cell, msg)
            except Exception:
                # one malformed message (missing/mistyped fields) costs its
                # SENDER the connection — never the broker loop, and never
                # the sibling workers' coordination
                self._drop(conn, cell, reclaim=True)
                return

    def _handle(self, conn: socket.socket, cell: list, msg: dict) -> None:
        lease: Optional[ProcLease] = cell[0]
        op = msg.get("op")
        if lease is not None:
            lease.last_beat = time.monotonic()
        if op == "register":
            # the fencing handshake: the client adopts this incarnation
            # and epoch watermark before any grant of ours is applied
            try:
                send_msg(conn, {"op": "welcome",
                                "incarnation": self.incarnation,
                                "epoch": self._epoch,
                                "capacity": self.capacity})
            except OSError:
                self._drop(conn, cell, reclaim=lease is not None)
                return
            with self._lock:
                if lease is None:
                    # want=0 is legal (a pure best-effort registration):
                    # the liveness floor belongs at grant application
                    # (the client floors set_slot_target at 1), never in
                    # the demand model — flooring here would pin a node
                    # slot on every idle process forever
                    want = max(0, int(msg.get("slots", 1)))
                    lease = ProcLease(
                        next(_WID),
                        str(msg.get("name", "worker")),
                        int(msg.get("pid", 0)),
                        max(0.0, float(msg.get("share", 1.0))),
                        want,
                        conn,
                        self._make_demand(want),
                    )
                    cell[0] = lease
                    self._table.add(lease.wid, lease)
                    self.registrations += 1
                else:  # re-register: update the existing lease in place
                    lease.share = max(0.0, float(msg.get("share", lease.share)))
                    lease.want = max(0, int(msg.get("slots", lease.want)))
                    lease.demand.set_width(lease.want)
                self._regrant()
        elif op == "heartbeat":
            if lease is None:
                # register precedes heartbeats; a heartbeat from an
                # unregistered connection means the register was lost.
                # Drop the connection: the worker's reconnect loop
                # re-registers it (self-healing, never a silent limbo).
                self._drop(conn, cell, reclaim=False)
            else:
                # envelope v2: the beat may piggyback the sender's live
                # runnable backlog. Absent = a v1 client (static demand,
                # fully supported); present-but-malformed = a protocol
                # violation that costs the SENDER its connection (the
                # raise lands in _service's malformed-message handler).
                if "backlog" in msg:
                    backlog = msg["backlog"]
                    if (not isinstance(backlog, int)
                            or isinstance(backlog, bool) or backlog < 0):
                        raise ProtocolError(
                            f"malformed heartbeat backlog: {backlog!r}")
                    with self._lock:
                        moved = lease.demand.observe(
                            backlog, time.monotonic())
                        if moved is not None:
                            self.demand_regrants += 1
                            self._regrant()
                # the current grant rides the ack (idempotent refresh):
                # a lost grant push heals within one heartbeat interval
                try:
                    send_msg(conn, self._grant_msg(lease, len(self._table)))
                except OSError:
                    self._drop(conn, cell, reclaim=True)
        elif op == "resize":
            if lease is not None:
                with self._lock:
                    lease.share = max(0.0, float(msg.get("share", lease.share)))
                    if "slots" in msg:
                        lease.want = max(0, int(msg["slots"]))
                        lease.demand.set_width(lease.want)
                    self._regrant()
        elif op == "rescale":
            # the MeshRescaleEvent routing: multiply the node share by the
            # surviving-device fraction (cross-process reclaim/regrowth)
            if lease is not None:
                with self._lock:
                    lease.share = max(0.0, lease.share * float(msg["scale"]))
                    self._regrant()
        elif op == "deregister":
            self._drop(conn, cell, reclaim=True)
        elif op == "stats":
            try:
                send_msg(conn, {"op": "snapshot", **self.snapshot()})
            except OSError:
                self._drop(conn, cell, reclaim=True)
        # unknown ops are ignored (forward compatibility)

    def _drop(self, conn: socket.socket, cell: list, *, reclaim: bool) -> None:
        lease: Optional[ProcLease] = cell[0]
        try:
            self._sel.unregister(conn)
        except (KeyError, ValueError):
            pass
        try:
            conn.close()
        except OSError:
            pass
        if lease is None:
            return
        cell[0] = None
        with self._lock:
            if lease.wid in self._table:
                self._table.pop(lease.wid)
                if reclaim:
                    self.reclaims += 1
                self._regrant()

    def _flush_dead(self) -> None:
        """Drop connections whose grant push failed (deferred from
        ``_regrant``, which runs under the table lock)."""
        while self._dead_conns:
            conn = self._dead_conns.pop()
            try:
                key = self._sel.get_key(conn)
            except (KeyError, ValueError):
                continue  # already dropped (EOF raced the failed push)
            self._drop(conn, key.data, reclaim=True)

    def _reap_stale(self) -> None:
        """Heartbeat liveness: reclaim leases of silent workers (wedged
        process, or a kill the socket layer has not surfaced yet)."""
        deadline = time.monotonic() - self.heartbeat_timeout
        stale = [l for l in self._table.values() if l.last_beat < deadline]
        for lease in stale:
            key = None
            try:
                key = self._sel.get_key(lease.conn)
            except (KeyError, ValueError):
                pass
            if key is not None:
                self._drop(lease.conn, key.data, reclaim=True)
            else:  # connection already gone: just reclaim the lease
                with self._lock:
                    if lease.wid in self._table:
                        self._table.pop(lease.wid)
                        self.reclaims += 1
                        self._regrant()

    # ------------------------------------------------------------------ #
    # apportionment (the LeaseTable consumer — caller holds self._lock)
    # ------------------------------------------------------------------ #
    def _make_demand(self, want: int) -> DemandState:
        return DemandState(want, beats=self.demand_beats,
                           alpha=self.demand_alpha,
                           min_interval=self.min_regrant_interval)

    def _regrant(self) -> None:
        """Recompute every worker's grant and push the *changes*.

        Quotas come from the shared largest-remainder apportionment;
        capacity a worker cannot use (its damped **effective want** — the
        live-backlog demand model, not the static registration width — is
        below its quota) is redistributed one slot at a time in the
        shared I5 borrow order: a worker only exceeds its quota after
        every under-quota worker's demand is met, the node-level grant
        rule. Workers whose grant content is unchanged are NOT re-pushed
        (``grants_suppressed``): a steady-state recompute — a heartbeat
        or no-op resize at constant demand — costs zero sends, and the
        idempotent grant copy riding every heartbeat ack remains the
        healing path for a lost push."""
        self._table.recompute()
        entries = list(self._table.values())
        for e in entries:
            e.granted = min(e.quota, e.eff_want)
            e.in_use = e.granted
        pool = self.capacity - sum(e.granted for e in entries)
        while pool > 0:
            hungry = [e for e in entries if e.eff_want > e.granted]
            if not hungry:
                break
            e = borrow_order(hungry)[0]
            e.granted += 1
            e.in_use = e.granted
            pool -= 1
        self.regrants += 1
        dirty = [e for e in entries if (e.granted, e.quota) != e.last_pushed]
        self.grants_suppressed += len(entries) - len(dirty)
        if not dirty:
            return  # nothing moved: no epoch burn, no pushes
        self._epoch += 1
        for e in dirty:
            try:
                send_msg(e.conn, self._grant_msg(e, len(entries)))
                e.last_pushed = (e.granted, e.quota)
                self.grants_pushed += 1
            except OSError:
                # a client not draining its socket (wedged) or already
                # gone: grants are tiny, so a full buffer means hundreds
                # of unread pushes — and a partial frame has corrupted
                # the stream anyway. Schedule the drop; the serve loop
                # performs it outside this lock.
                self._dead_conns.append(e.conn)

    def _grant_msg(self, e: ProcLease, n_workers: int) -> dict:
        return {
            "op": "grant",
            "slots": e.granted,
            "quota": e.quota,
            "capacity": self.capacity,
            "workers": n_workers,
            "epoch": self._epoch,
            "incarnation": self.incarnation,
        }

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "incarnation": self.incarnation,
                "epoch": self._epoch,
                "registrations": self.registrations,
                "reclaims": self.reclaims,
                "regrants": self.regrants,
                "demand_regrants": self.demand_regrants,
                "grants_pushed": self.grants_pushed,
                "grants_suppressed": self.grants_suppressed,
                "workers": self._worker_rows(),
            }

    def _worker_rows(self) -> dict:
        """Per-worker rows keyed by name — disambiguated with the unique
        wid on collision (e.g. several clients left at the default name),
        so no lease silently vanishes from the snapshot."""
        rows: dict = {}
        for l in self._table.values():
            key = l.name if l.name not in rows else f"{l.name}#{l.wid}"
            rows[key] = {
                "wid": l.wid,
                "pid": l.pid,
                "share": l.share,
                "quota": l.quota,
                "granted": l.granted,
                "want": l.want,
                "eff_want": l.eff_want,
                "backlog": l.demand.last_backlog,
            }
        return rows


def main(argv=None) -> int:
    """Standalone node broker: ``python -m repro_torch.ipc.broker``."""
    ap = argparse.ArgumentParser(description="USF node-level lease broker")
    ap.add_argument("--path", default=None,
                    help="Unix socket path (default: per-user tmp path)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="node slots to apportion (default: cpu count)")
    ap.add_argument("--heartbeat-timeout", type=float, default=1.0)
    ap.add_argument("--demand-beats", type=int, default=3,
                    help="hysteresis depth K for backlog-driven regrants")
    ap.add_argument("--demand-alpha", type=float, default=0.5,
                    help="EWMA weight for the backlog smoother")
    ap.add_argument("--min-regrant-interval", type=float, default=0.25,
                    help="per-worker floor (s) between demand regrants")
    args = ap.parse_args(argv)
    broker = NodeBroker(args.path, capacity=args.capacity,
                        heartbeat_timeout=args.heartbeat_timeout,
                        demand_beats=args.demand_beats,
                        demand_alpha=args.demand_alpha,
                        min_regrant_interval=args.min_regrant_interval)
    print(f"usf-node-broker: serving {broker.capacity} slots on "
          f"{broker.path}", flush=True)
    try:
        broker.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        broker.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
