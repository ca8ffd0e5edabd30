"""Cross-process USF: the node-level coordination layer.

The paper's headline results are *multi-process*: independent processes
(nested BLAS, multi-process LLaMA inference, MD) co-located on one node,
coordinated purely in user space. This package is that layer:

* ``NodeBroker`` (broker.py) — one per node: apportions the node's slots
  across registered processes with the same lease machinery
  (``repro_torch.core.lease``) the in-process ``SlotArbiter`` uses for jobs;
  heartbeat-based liveness reclaims a dead worker's lease. Since PR 9
  apportionment is **demand-aware**: it runs over each worker's live,
  hysteresis-damped effective want (``DemandState`` — backlog feedback
  piggybacked on heartbeats, envelope v2) instead of the static
  registration width, and regrant pushes are deduplicated (unchanged
  grants are never re-sent; ``grants_suppressed`` counts the saves).
* ``BrokerClient`` (client.py) — one per worker process: registers a
  share, receives grants, and lands them on the runtime's elastic slot
  parking (``UsfRuntime.set_slot_target``). Each heartbeat piggybacks
  the worker's instantaneous runnable backlog — the bound runtime's
  lock-free ``runnable_backlog()`` probe by default, an arbitrary
  ``backlog_probe`` (e.g. request-queue depth) otherwise;
  ``report_backlog=False`` keeps the static v1 contract.
* ``FaultPlan`` (faults.py) — a seeded, deterministic fault injector
  wrapped around a client's protocol layer (drops, delays, truncated
  frames, duplicated/reordered grants, resets, heartbeat stalls); the
  chaos suite (tests/test_chaos.py) drives it.
* ``protocol`` — the tiny length-prefixed JSON framing over Unix sockets.

Failure/recovery semantics (coordination is an optimization, never a
liveness dependency — and the system heals, it does not merely survive):

* **Degrade immediately, heal in the background.** A lost broker (EOF,
  send failure, reset) drops the worker to free-running at full local
  width at once; a reconnect loop with exponential backoff + jitter then
  re-registers it under the same name/share/demand and resumes
  coordination. The client walks a transient
  ``COORDINATED → DEGRADED → RECONNECTING → COORDINATED`` state machine
  (``BrokerClient.state``); ``reconnect=False`` restores the terminal
  degrade.
* **Epoch fencing.** Every broker start mints an ``incarnation`` id,
  sent on the ``welcome`` handshake and carried on every grant alongside
  the monotonic grant ``epoch``. Clients drop grants from a stale
  (incarnation, epoch) pair — a grant racing a reconnect can never
  shrink a worker on a dead broker's authority. A restarted broker takes
  over the rendezvous path and rebuilds its lease table purely from
  re-registrations.
* **Typed failures, never hangs.** Lease ops (``resize``/``rescale``)
  on a lost broker raise ``BrokerLostError`` (a ``ConnectionError``);
  the share change is still recorded locally and carried by the next
  re-registration (queued-or-rejected).
* **Lost-message healing.** The current grant rides every heartbeat ack,
  so a dropped grant push heals within one heartbeat interval; a
  heartbeat from an unregistered connection (lost ``register``) drops
  the connection so the worker's reconnect loop re-registers it.
* **Demand feedback degrades gracefully.** A worker that cannot probe
  its backlog (no runtime bound, probe raising) simply beats without the
  field and is treated as static-demand (v1); a *malformed* backlog —
  garbage type, negative — is a protocol violation that costs the sender
  its connection, never the broker loop or a sibling's coordination.
  Zero is a legal demand end to end (``want=0`` registration,
  ``backlog=0`` beats): the broker may grant nothing, and the liveness
  floor is applied only where grants land (``set_slot_target`` floors at
  one slot).

See docs/IPC.md for the envelope-v2 wire format and the demand model's
knobs (hysteresis depth, EWMA weight, min-regrant interval).

Scheduling is thus three-level: NodeBroker (processes) → SlotArbiter
(jobs) → intra-job policies (tasks), every level speaking leases.
"""

from repro_torch.ipc.broker import BrokerError, NodeBroker, ProcLease
from repro_torch.ipc.client import BrokerClient, BrokerLostError, backoff_delays
from repro_torch.ipc.faults import FaultPlan
from repro_torch.ipc.protocol import default_socket_path

__all__ = [
    "NodeBroker",
    "BrokerClient",
    "BrokerError",
    "BrokerLostError",
    "FaultPlan",
    "ProcLease",
    "backoff_delays",
    "default_socket_path",
]
