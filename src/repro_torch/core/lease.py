"""Reusable lease/quota machinery — shared by the in-process ``SlotArbiter``
and the cross-process ``NodeBroker`` (repro_torch.ipc).

Both arbitration layers answer the same question at different scopes: given
a capacity of slots and a set of share-weighted claimants, what integer
entitlement does each claimant hold (largest-remainder apportionment), and
in what order may claimants be *granted* capacity so that the grant rule —
invariant I5: *no claimant is granted capacity beyond its lease while a
sibling with spare lease has demand* — holds structurally?

The in-process arbiter apportions one ``Scheduler``'s slots across job
leases; the node broker apportions one *node*'s slots across registered
processes. Extracting the machinery here keeps the two layers
behaviour-identical (property-tested in tests/test_lease_table.py) and the
arbiter's single-group fast path untouched (the table is only consulted at
membership/share changes, never per pick).

Entries are caller-owned objects exposing three attributes the table reads
and writes: ``share`` (relative weight, read), ``quota`` (integer
entitlement, written by ``recompute``) and ``in_use`` (currently consumed
capacity, read by the borrow order). ``SlotLease`` (arbiter) and
``ProcLease`` (broker) both qualify.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, TypeVar

E = TypeVar("E")


def apportion(capacity: int, shares: Sequence[float]) -> list[int]:
    """Largest-remainder apportionment of ``capacity`` integer slots over
    relative ``shares``. All-zero (or all-negative-clamped) share vectors
    fall back to equal entitlement. Quotas sum exactly to ``capacity``
    (for ``capacity >= 0``); an empty share vector yields ``[]``."""
    n = len(shares)
    if n == 0 or capacity <= 0:
        return [0] * n
    total = float(sum(shares))
    if total <= 0.0:
        exacts = [capacity / float(n)] * n
    else:
        exacts = [capacity * s / total for s in shares]
    quotas = [int(e) for e in exacts]
    granted = sum(quotas)
    remainders = sorted(
        (-(exact - q), i) for i, (exact, q) in enumerate(zip(exacts, quotas))
    )
    for k in range(capacity - granted):
        quotas[remainders[k][1]] += 1
    return quotas


def borrow_order(entries: Iterable[E]) -> list[E]:
    """The I5 grant order over lease entries: claimants holding spare lease
    first (largest spare wins), then — work-conserving borrowing — the
    claimants already at/over quota, least-over first; ties resolve by the
    given (attach) order. A borrowing grant is therefore only reachable
    after every spare-lease claimant declined, which is exactly the I5
    grant rule both arbitration layers enforce structurally."""
    return [e for _, _, e in
            sorted((e.in_use - e.quota, i, e) for i, e in enumerate(entries))]


class LeaseTable:
    """An insertion-ordered table of lease entries over one capacity pool.

    Owns no policy: it only maps shares to integer quotas (``recompute``)
    and exposes the I5 borrow order (``grant_order``). The arbiter keys
    entries by job id, the broker by worker id.
    """

    __slots__ = ("capacity", "entries")

    def __init__(self, capacity: int = 0):
        self.capacity = int(capacity)
        #: key -> entry, in attach order (dict preserves insertion order;
        #: the borrow order's tie-break and the largest-remainder scan
        #: order both follow it)
        self.entries: dict = {}

    # -- membership ----------------------------------------------------- #
    def add(self, key, entry) -> None:
        self.entries[key] = entry

    def pop(self, key):
        return self.entries.pop(key)

    def get(self, key, default=None):
        return self.entries.get(key, default)

    def values(self):
        return self.entries.values()

    def __contains__(self, key) -> bool:
        return key in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    # -- apportionment & grant order ------------------------------------ #
    def recompute(self) -> None:
        """Write largest-remainder quotas into every entry (``entry.quota``)
        from the current shares and capacity."""
        entries = list(self.entries.values())
        quotas = apportion(self.capacity, [e.share for e in entries])
        for entry, q in zip(entries, quotas):
            entry.quota = q

    def grant_order(self, entries: Optional[Iterable] = None) -> list:
        """I5 borrow order over ``entries`` (default: every entry)."""
        return borrow_order(self.entries.values()
                            if entries is None else entries)

    def spare(self) -> int:
        """Capacity not consumed by current ``in_use`` (may go negative
        transiently while a reclaim is in flight)."""
        return self.capacity - sum(e.in_use for e in self.entries.values())

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"LeaseTable({len(self.entries)} leases / {self.capacity})"
