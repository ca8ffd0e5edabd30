"""Deterministic fault injection for the broker protocol layer.

A ``FaultPlan`` is a *seeded* source of fault decisions wrapped around a
``BrokerClient``'s protocol send/recv path (pass ``faults=plan`` to the
client). Every decision comes from one ``random.Random(seed)`` stream, so
a schedule is reproducible: the same seed injects the same faults at the
same protocol steps. The injectable fault classes are the ones the
self-healing layer must survive:

* **message drops** (send and recv side) — a lost ``register`` heals via
  the broker dropping unregistered heartbeaters; a lost ``grant`` heals
  via the grant refresh riding the next heartbeat ack;
* **delays** — slow delivery must never corrupt ordering (epoch fencing);
* **truncated frames** — a partial frame poisons the stream; the broker
  drops the sender, the client reconnects;
* **duplicated / reordered grants** — must be idempotent / fenced by the
  monotonic (incarnation, epoch) guard;
* **connection resets** — the full outage machinery: degrade to
  free-running, reconnect with backoff, re-register, re-coordinate;
* **heartbeat stalls** — a silent-but-connected worker is reaped by the
  broker's heartbeat timeout and must rejoin on its own.

``horizon`` bounds the number of injected faults (then the plan disarms
itself); ``clear()`` disarms explicitly — the chaos suite injects for a
window, clears, and asserts bounded re-convergence. ``injected`` counts
every fault by kind for assertions and MTTR attribution.
"""

from __future__ import annotations

import random
from collections import Counter
from typing import Optional

from repro_torch.ipc.protocol import _LEN

#: send/recv actions a plan can decide (PASS is implicit)
PASS = "pass"
DROP = "drop"
TRUNCATE = "truncate"
RESET = "reset"


def truncated_frame(promised: int = 64) -> bytes:
    """A frame header promising ``promised`` body bytes followed by a
    deliberately short body — the receiver blocks mid-frame until the
    sender closes, then sees EOF-mid-frame (``ProtocolError``)."""
    return _LEN.pack(promised) + b'{"op":"truncated"'


class FaultPlan:
    """Seeded fault schedule for one client's protocol layer.

    Parameters are per-event probabilities in ``[0, 1]``; all decisions
    draw from one seeded RNG stream. ``delay_range``/``stall_beats`` are
    inclusive ranges for injected delay seconds / swallowed heartbeats.
    ``horizon`` caps the total number of injected faults (None: no cap).
    """

    def __init__(self, seed: int = 0, *,
                 drop_send: float = 0.0, truncate_send: float = 0.0,
                 reset_send: float = 0.0, delay_send: float = 0.0,
                 drop_recv: float = 0.0, dup_recv: float = 0.0,
                 reorder_recv: float = 0.0, reset_recv: float = 0.0,
                 delay_recv: float = 0.0,
                 delay_range: tuple = (0.001, 0.02),
                 heartbeat_stall: float = 0.0,
                 stall_beats: tuple = (2, 6),
                 horizon: Optional[int] = None):
        self.seed = seed
        self._rng = random.Random(seed)
        self.drop_send = drop_send
        self.truncate_send = truncate_send
        self.reset_send = reset_send
        self.delay_send = delay_send
        self.drop_recv = drop_recv
        self.dup_recv = dup_recv
        self.reorder_recv = reorder_recv
        self.reset_recv = reset_recv
        self.delay_recv = delay_recv
        self.delay_range = delay_range
        self.heartbeat_stall = heartbeat_stall
        self.stall_beats = stall_beats
        self.horizon = horizon
        #: injected-fault counts by kind (chaos assertions / attribution)
        self.injected: Counter = Counter()
        self._held: Optional[dict] = None  # buffered msg (reorder in flight)
        self._stall_left = 0               # heartbeats still to swallow
        self._armed = True

    # ------------------------------------------------------------------ #
    # arming
    # ------------------------------------------------------------------ #
    @property
    def armed(self) -> bool:
        return self._armed

    def clear(self) -> None:
        """Disarm: no further faults are injected (held reorder buffers
        are released on the next recv so no message is lost forever)."""
        self._armed = False

    def total_injected(self) -> int:
        return sum(self.injected.values())

    def _fire(self, kind: str) -> bool:
        """Record one injected fault; auto-disarm past the horizon."""
        self.injected[kind] += 1
        if self.horizon is not None and self.total_injected() >= self.horizon:
            self._armed = False
        return True

    def _roll(self, p: float) -> bool:
        return p > 0.0 and self._rng.random() < p

    def _delay(self) -> float:
        lo, hi = self.delay_range
        return lo + (hi - lo) * self._rng.random()

    # ------------------------------------------------------------------ #
    # client send path
    # ------------------------------------------------------------------ #
    def send_action(self, msg: dict) -> tuple:
        """Decide the fate of one outgoing message: ``(action, delay_s)``.
        ``DROP`` swallows it, ``TRUNCATE`` replaces it with a poisoned
        partial frame, ``RESET`` severs the connection instead of
        sending."""
        if not self._armed:
            return PASS, 0.0
        delay = 0.0
        if self._roll(self.delay_send):
            delay = self._delay()
            self._fire("delay_send")
        if self._roll(self.drop_send):
            self._fire("drop_send")
            return DROP, delay
        if self._roll(self.truncate_send):
            self._fire("truncate_send")
            return TRUNCATE, delay
        if self._roll(self.reset_send):
            self._fire("reset_send")
            return RESET, delay
        return PASS, delay

    # ------------------------------------------------------------------ #
    # client recv path
    # ------------------------------------------------------------------ #
    def recv_actions(self, msg: dict) -> tuple:
        """Decide the fate of one incoming message:
        ``(action, delay_s, msgs)`` — ``msgs`` is what to actually
        deliver (possibly empty, duplicated, or swapped with a previously
        held message: the out-of-order pair the epoch fence must drop).
        ``RESET`` severs the connection (nothing delivered)."""
        if not self._armed:
            held, self._held = self._held, None
            return PASS, 0.0, ([msg, held] if held is not None else [msg])
        delay = 0.0
        if self._roll(self.delay_recv):
            delay = self._delay()
            self._fire("delay_recv")
        if self._roll(self.reset_recv):
            self._fire("reset_recv")
            return RESET, delay, []
        if self._roll(self.drop_recv):
            self._fire("drop_recv")
            return PASS, delay, []
        if self._roll(self.reorder_recv):
            if self._held is None:
                # hold this message; it is delivered AFTER its successor
                self._held = msg
                self._fire("reorder_recv")
                return PASS, delay, []
        out = [msg]
        if self._held is not None:
            out.append(self._held)  # released out of order, by design
            self._held = None
        if self._roll(self.dup_recv):
            self._fire("dup_recv")
            out = out + [dict(msg)]
        return PASS, delay, out

    # ------------------------------------------------------------------ #
    # heartbeat path
    # ------------------------------------------------------------------ #
    def stall_heartbeat(self) -> bool:
        """True if the current heartbeat should be swallowed (a stall run
        covers ``stall_beats`` consecutive beats — long enough runs trip
        the broker's heartbeat timeout and force a full rejoin)."""
        if self._stall_left > 0:
            self._stall_left -= 1
            return True
        if self._armed and self._roll(self.heartbeat_stall):
            lo, hi = self.stall_beats
            self._stall_left = self._rng.randint(lo, hi) - 1
            self._fire("heartbeat_stall")
            return True
        return False

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"FaultPlan(seed={self.seed}, armed={self._armed}, "
                f"injected={dict(self.injected)})")
