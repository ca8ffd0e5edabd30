"""Mesh rescale → slot-lease resize: one elastic path for devices & slots.

``repro_torch.launch.elastic`` demonstrates device-level elasticity: a run
continues on a degraded mesh after losing capacity. The job-level
``SlotArbiter`` exposes the same elastic primitive for *slots*
(``SlotLease.resize``). This module wires the two together so device
reclaim and slot reclaim share one path: a ``MeshRescaleEvent`` (devices
lost or regained) is applied proportionally to the job's slot lease — a
job that just lost half its mesh also surrenders half its CPU-side slot
share to its co-located siblings, and regains it when the mesh regrows.

Reclaim semantics are the lease's: grants fill idle slots immediately;
reclaims land at the borrower's next scheduling point, or within one
watchdog/sim tick period for preemptive intra-job policies (SCHED_COOP
jobs are never preempted for reclaim — I2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Iterable, Optional

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.arbiter import SlotLease


@dataclasses.dataclass(frozen=True)
class MeshRescaleEvent:
    """A mesh shape change (node failure, capacity reclaim, or regrowth)."""

    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]

    @property
    def old_devices(self) -> int:
        return math.prod(self.old_shape)

    @property
    def new_devices(self) -> int:
        return math.prod(self.new_shape)

    @property
    def scale(self) -> float:
        """Surviving-device fraction (may exceed 1.0 on regrowth)."""
        if self.old_devices <= 0:
            raise ValueError(f"empty source mesh {self.old_shape}")
        return self.new_devices / self.old_devices


def apply_rescale(lease: "SlotLease", event: MeshRescaleEvent) -> float:
    """Resize ``lease`` in proportion to the event's device change; returns
    the new share. The arbiter re-apportions quotas under its scheduler's
    lock, so this is safe to call from a rescale-monitoring thread."""
    new_share = lease.share * event.scale
    lease.resize(new_share)
    return new_share


class ElasticCoordinator:
    """Fans one mesh-rescale event out to every registered job lease.

    The launch layer (``repro_torch.launch.elastic``) owns mesh transitions; the
    scheduling layer owns slot leases. The coordinator is the seam between
    them: ``register`` the leases of jobs whose slot share should track
    their device share, then call ``on_rescale`` whenever the mesh changes.

    ``runtime`` (a ``SimExecutor`` or ``UsfRuntime`` — anything exposing
    ``demote(job)``) enables ``demote_on_collapse`` registrations: a job
    whose mesh shrinks to zero devices is *live-demoted* into the shared
    default group instead of being left holding a dedicated zero-share
    lease — the rescale-driven policy swap without drain. With a
    ``policy_factory`` the round-trip closes automatically: the demoted
    job is **re-promoted** — a fresh dedicated lease under a fresh policy
    instance from the factory — on the first event that regrows its mesh
    to more than zero devices, at a share scaled by the regrown fraction.
    Without a factory the demoted job leaves elastic tracking (the PR 4
    behaviour); re-promote it manually with ``attach`` + ``register``.

    ``broker`` (a ``repro_torch.ipc.BrokerClient``, or anything exposing
    ``rescale(scale)``) routes every event to the *node-level* lease too:
    the process that lost half its devices also surrenders half its node
    slot share to co-located sibling processes — cross-process reclaim
    riding the same event stream as the in-process leases.
    """

    def __init__(self, runtime=None, broker=None) -> None:
        self._runtime = runtime
        self._broker = broker
        self._leases: list["SlotLease"] = []
        #: opt-in keyed by LEASE identity, not jid: a stale registration's
        #: flag must die with it, never eclipsing (or erasing) the flag of
        #: a newer live registration for the same job
        self._demote_on_collapse: set["SlotLease"] = set()
        #: lease -> zero-arg Policy factory for auto re-promotion
        self._policy_factories: dict[int, object] = {}  # id(lease) -> factory
        #: jid -> (job, factory, share-at-collapse, devices-at-collapse):
        #: jobs demoted by a collapse, waiting for their mesh to regrow
        self._collapsed: dict[int, tuple] = {}
        #: (node share, devices) before a collapse zeroed the broker
        #: lease — a multiplicative rescale cannot recover from 0, so the
        #: regrow restores the share absolutely via ``broker.resize``
        self._broker_collapsed: Optional[tuple] = None

    def register(self, lease: "SlotLease", *,
                 demote_on_collapse: bool = False,
                 policy_factory=None) -> "SlotLease":
        if demote_on_collapse and self._runtime is None:
            raise ValueError(
                "demote_on_collapse needs a runtime exposing demote(job); "
                "pass it to ElasticCoordinator(runtime=...)"
            )
        if demote_on_collapse and not lease.group.dedicated:
            raise ValueError(
                f"demote_on_collapse needs a dedicated lease; {lease.job} "
                "already runs in the default group (nothing to demote)"
            )
        if policy_factory is not None and not demote_on_collapse:
            raise ValueError(
                "policy_factory only makes sense with demote_on_collapse "
                "(it rebuilds the dedicated policy at re-promotion)"
            )
        if lease not in self._leases:  # re-register only updates the flag:
            self._leases.append(lease)  # a duplicate would resize twice
        if demote_on_collapse:
            self._demote_on_collapse.add(lease)
            if policy_factory is not None:
                self._policy_factories[id(lease)] = policy_factory
            else:
                self._policy_factories.pop(id(lease), None)
        else:
            # re-registering the same lease without the flag revokes its
            # opt-in; a FRESH lease simply never carries the old one's
            self._demote_on_collapse.discard(lease)
            self._policy_factories.pop(id(lease), None)
        return lease

    def leases(self) -> Iterable["SlotLease"]:
        return tuple(self._leases)

    def on_rescale(self, event: MeshRescaleEvent) -> dict[str, float]:
        """Apply the event to every registered lease; returns the new
        shares keyed by job name (0.0 for a job demoted on collapse —
        its dedicated share is released wholesale). Regrowth events
        (new_devices > 0) first re-promote any collapse-demoted job that
        registered a ``policy_factory``; the event is also routed to the
        node-level broker lease when one is wired in."""
        shares: dict[str, float] = {}
        fresh: list["SlotLease"] = []
        if event.new_devices > 0 and self._collapsed:
            repromoted, fresh = self._repromote(event)
            shares.update(repromoted)
        survivors: list["SlotLease"] = []
        for lease in self._leases:
            if any(lease is f for f in fresh):
                # re-promoted by THIS event: its share already reflects the
                # regrown mesh — applying the event again would square it
                survivors.append(lease)
                continue
            if lease.job.lease is not lease:
                # superseded out-of-band (a live swap/demote/detach the
                # coordinator did not perform): the registration is dead —
                # drop it (and only ITS flag) rather than resize a lease
                # no quota reads; the job's new lease needs a fresh
                # register()
                self._demote_on_collapse.discard(lease)
                self._policy_factories.pop(id(lease), None)
                continue
            if (event.new_devices == 0
                    and lease in self._demote_on_collapse):
                factory = self._policy_factories.pop(id(lease), None)
                pre_share = lease.share
                self._runtime.demote(lease.job)
                self._demote_on_collapse.discard(lease)
                shares[lease.job.name] = 0.0
                if factory is not None:
                    # remember enough to re-promote when the mesh regrows:
                    # the share scales by regrown/pre-collapse devices
                    self._collapsed[lease.job.jid] = (
                        lease.job, factory, pre_share, event.old_devices)
                continue  # the dedicated lease is dead: stop tracking it
            if event.old_devices == 0:
                # a regrow-from-nothing defines no ratio for jobs that
                # were never collapsed: their shares are left untouched
                # (the event only feeds the re-promotion pass above)
                shares[lease.job.name] = lease.share
                survivors.append(lease)
                continue
            shares[lease.job.name] = apply_rescale(lease, event)
            survivors.append(lease)
        self._leases = survivors
        if self._broker is not None:
            # cross-process reclaim: the node-level share tracks the same
            # device fraction the in-process leases just applied
            if event.new_devices == 0 and event.old_devices > 0:
                # collapse: remember the pre-zero node share — 0 times
                # any later scale stays 0, so the regrow must restore
                # absolutely, not multiplicatively
                self._broker_collapsed = (self._broker.share,
                                          event.old_devices)
                self._broker.rescale(0.0)
            elif event.old_devices == 0:
                if self._broker_collapsed is not None:
                    share0, dev0 = self._broker_collapsed
                    self._broker_collapsed = None
                    self._broker.resize(
                        share0 * event.new_devices / dev0)
            else:
                self._broker.rescale(event.scale)
        return shares

    def _repromote(self, event: MeshRescaleEvent
                   ) -> tuple[dict[str, float], list]:
        """Close the collapse round-trip: re-attach every recorded
        collapse-demoted job under a fresh dedicated policy, at the
        pre-collapse share scaled by the regrown device fraction, and
        re-register it (flag and factory intact) so later events keep
        tracking it."""
        shares: dict[str, float] = {}
        fresh: list["SlotLease"] = []
        for jid, (job, factory, pre_share, pre_devices) in list(
                self._collapsed.items()):
            del self._collapsed[jid]
            cur = job.lease
            if cur is not None and cur.group.dedicated:
                # re-promoted out-of-band (a manual attach): leave the
                # manual registration — if any — in charge
                continue
            new_share = pre_share * (event.new_devices / pre_devices
                                     if pre_devices > 0 else 1.0)
            lease = self._runtime.attach(job, policy=factory(),
                                         share=new_share)
            self.register(lease, demote_on_collapse=True,
                          policy_factory=factory)
            shares[job.name] = new_share
            fresh.append(lease)
        return shares, fresh
