"""Execution-resource topology.

Paper: cores grouped into NUMA domains (2 sockets x 56 cores).
TPU adaptation: *slots* (device partitions) grouped into ICI neighborhoods;
cross-domain = crossing the slow axis (other socket / other pod half / DCN).

The scheduler only ever needs a distance oracle:
    0 = same slot (perfect affinity: warm HBM/L2),
    1 = same domain (cheap migration),
    2 = remote domain (expensive migration).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Slot:
    """One execution resource: a core (paper) or a device partition (TPU)."""

    sid: int
    domain: int

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Slot({self.sid}@d{self.domain})"


class Topology:
    """A fixed set of slots partitioned into locality domains."""

    def __init__(self, n_slots: int, n_domains: int = 1, *, name: str = "node"):
        if n_slots <= 0:
            raise ValueError("need at least one slot")
        if n_domains <= 0 or n_slots % n_domains != 0:
            raise ValueError(f"{n_slots} slots not divisible into {n_domains} domains")
        self.name = name
        self.n_domains = n_domains
        per = n_slots // n_domains
        self.slots: list[Slot] = [Slot(i, i // per) for i in range(n_slots)]
        self._per_domain = per
        #: per-slot distance-ordered neighbor tuples, built lazily — the
        #: allocation-free fast path behind ``neighbors_first`` for hot
        #: per-pick placement searches (SCHED_COOP §4.1)
        self._neighbor_cache: list[Optional[tuple[Slot, ...]]] = [None] * n_slots

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def domain_slots(self, domain: int) -> Sequence[Slot]:
        lo = domain * self._per_domain
        return self.slots[lo : lo + self._per_domain]

    def domain_of(self, sid: int) -> int:
        return self.slots[sid].domain

    def distance(self, a: int, b: int) -> int:
        """0 same slot, 1 same domain, 2 cross domain."""
        if a == b:
            return 0
        return 1 if self.domain_of(a) == self.domain_of(b) else 2

    def neighbors_first(self, sid: int) -> tuple[Slot, ...]:
        """All slots ordered by distance from ``sid`` (affinity search order).

        This is the SCHED_COOP placement order of §4.1: preferred core, then
        same NUMA domain, then everything else. The tuple is computed once
        per slot and cached, so per-pick placement searches allocate nothing.
        """
        cached = self._neighbor_cache[sid]
        if cached is None:
            home = self.slots[sid]
            order = [home]
            order.extend(
                s for s in self.domain_slots(home.domain) if s.sid != sid
            )
            order.extend(s for s in self.slots if s.domain != home.domain)
            cached = self._neighbor_cache[sid] = tuple(order)
        return cached

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Topology({self.name}: {self.n_slots} slots / {self.n_domains} domains)"


def pod_topology(n_chips: int = 256, neighborhoods: int = 2) -> Topology:
    """A TPU pod viewed as a scheduling topology (ICI halves as domains)."""
    return Topology(n_chips, neighborhoods, name=f"pod{n_chips}")


def node_topology(cores: int = 112, sockets: int = 2) -> Topology:
    """The paper's evaluation node: 2 x 56-core Sapphire Rapids."""
    return Topology(cores, sockets, name=f"node{cores}")
