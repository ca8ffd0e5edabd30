"""Adaptive tick-interval classes — shared by both executors.

The watchdog coalesces preemption ticks by *interval class* (one periodic
heap entry per distinct policy period, O(interval classes) heap entries).
A fixed period is the wrong granularity under SLO pressure: when a
deadline-bound job's laxity headroom shrinks below a couple of periods,
preemption requests must land faster than the configured slice, and when
the node is idle the class can relax back to its base period
(LibPreemptible's adaptive microsecond-granularity argument, PAPERS.md).

``SliceController`` owns that adaptation. It is deliberately *deterministic*
— a pure function of the observation sequence, no wall-clock or RNG — so
the discrete-event executor mirrors the real-thread watchdog exactly and
policies stay lockstep-testable across both.

Semantics per interval class (the base period is the class key, so the
watchdog heap stays O(interval classes) — adaptation changes the class's
*effective* period, never its identity):

* **shrink** (×1/2 per step, floored at ``base × min_scale``) only under
  *deadline pressure*: observed laxity headroom below
  ``pressure_periods × base``. Queue depth alone never shrinks a class —
  a saturated best-effort node keeps its exact base period, so every
  non-deadline simulation result stays bit-identical to the fixed-tick
  engine (the zero-cost-when-unused acceptance bar).
* **grow** (×2 per step, capped at the base) once the pressure clears
  *and* the observed ready-queue depth is zero — both signals of the
  ISSUE's "observed queue depth and laxity headroom" pair, with depth
  gating the relax direction so a backlogged class does not bounce.
* **bounded hysteresis**: a class only moves after ``shrink_after`` /
  ``grow_after`` consecutive observations agree, and each observation
  moves the scale at most one ×2 step, so the effective period is bounded
  in [base × min_scale, base] and cannot flap on alternating signals.
"""

from __future__ import annotations

from typing import Optional

#: defaults: shrink fast (one pressured observation), relax slowly (three
#: calm ones), floor at base/8 — a 3 ms SCHED_FAIR class bottoms out at
#: 375 µs, an order of magnitude below the fixed tick but still far above
#: timer-thread overhead territory
MIN_SCALE = 1.0 / 8.0
SHRINK_AFTER = 1
GROW_AFTER = 3
PRESSURE_PERIODS = 2.0


class _ClassState:
    __slots__ = ("scale", "shrink_streak", "grow_streak")

    def __init__(self) -> None:
        self.scale = 1.0
        self.shrink_streak = 0
        self.grow_streak = 0


class SliceController:
    """Deterministic per-interval-class tick-period adaptation."""

    __slots__ = ("min_scale", "shrink_after", "grow_after",
                 "pressure_periods", "_classes")

    def __init__(self, *, min_scale: float = MIN_SCALE,
                 shrink_after: int = SHRINK_AFTER,
                 grow_after: int = GROW_AFTER,
                 pressure_periods: float = PRESSURE_PERIODS):
        if not 0.0 < min_scale <= 1.0:
            raise ValueError(f"min_scale must be in (0, 1]: {min_scale}")
        self.min_scale = float(min_scale)
        self.shrink_after = max(1, int(shrink_after))
        self.grow_after = max(1, int(grow_after))
        self.pressure_periods = float(pressure_periods)
        #: base interval -> adaptation state; one entry per interval class
        self._classes: dict[float, _ClassState] = {}

    # -- reading -------------------------------------------------------- #
    def effective(self, base: float) -> float:
        """The class's current effective period (base × scale)."""
        st = self._classes.get(base)
        return base if st is None else base * st.scale

    def scale_of(self, base: float) -> float:
        st = self._classes.get(base)
        return 1.0 if st is None else st.scale

    def n_classes(self) -> int:
        return len(self._classes)

    # -- observing ------------------------------------------------------ #
    def observe(self, base: float, *, depth: int,
                laxity: Optional[float]) -> float:
        """Record one tick-time observation for the class of ``base`` and
        return the (possibly updated) effective period. ``depth`` is the
        arbiter-wide ready-queue depth, ``laxity`` the minimum deadline
        headroom (None = nothing deadline-bound pending)."""
        st = self._classes.get(base)
        if st is None:
            if laxity is None or laxity >= self.pressure_periods * base:
                return base  # calm and already at base: allocate nothing
            st = self._classes[base] = _ClassState()
        pressured = (laxity is not None
                     and laxity < self.pressure_periods * base)
        if pressured:
            st.grow_streak = 0
            st.shrink_streak += 1
            if st.shrink_streak >= self.shrink_after \
                    and st.scale > self.min_scale:
                st.scale = max(st.scale * 0.5, self.min_scale)
                st.shrink_streak = 0
        elif depth == 0:
            st.shrink_streak = 0
            st.grow_streak += 1
            if st.grow_streak >= self.grow_after and st.scale < 1.0:
                st.scale = min(st.scale * 2.0, 1.0)
                st.grow_streak = 0
        else:
            # backlogged but no deadline pressure: hold (no flapping)
            st.shrink_streak = 0
            st.grow_streak = 0
        if st.scale >= 1.0 and st.shrink_streak == 0 \
                and st.grow_streak == 0 and not pressured:
            del self._classes[base]  # settled back: state stays O(active)
            return base
        return base * st.scale

    def forget(self, base: float) -> None:
        """Drop a class's adaptation state (its last slot disarmed)."""
        self._classes.pop(base, None)
