"""Spans of the port's host work, on the scheduler's clock.

A span is one tuple ``(t0, t1, name, tid, key, attr)``, appended once,
when it ends. ``t0`` and ``t1`` are ``time.monotonic`` seconds, the clock
of the scheduler's decision records (``core/scheduler.py``), so a span and
a DISPATCH or YIELD of the same task can be ordered. ``tid`` is the USF
``Task.tid`` of the task that ran it (None off a task), ``key`` the unit
of work it belongs to (``(job name, step)``: a step's spans share it), and
``attr`` a number it carries (a microbatch's index, an engine step's
active slots) or None. Parents are not stored: a span's parent is the
innermost span of the same ``tid`` that encloses it.

The spans the port records:

* the trainer (``train/trainer.py``, ``train/step.py``): ``train.step``
  from the loader's call to just before the yield, holding
  ``train.loader``, ``train.h2d``, ``train.dispatch`` (holding one
  ``train.fwd_bwd`` a microbatch, ``attr`` its index, and
  ``train.optimizer``) and ``train.sync``; then ``train.yield``;
* the engine (``serve/engine.py``): ``engine.step`` (``attr`` the active
  slots after admit) holding ``engine.admit``, ``engine.dispatch`` and
  ``engine.sync``; ``engine.idle``, a blocking wait with no active slot.

One sink a process, disarmed until ``arm()``. A span site reads ``emit``
and, while it is None, does nothing else: no clock read, no tuple. Armed,
``emit`` is the ``append`` of an in-memory deque (one C call, as the
decision recorder's ``emit``)."""

from __future__ import annotations

import threading
import time
from collections import deque

#: the clock of every span, and of the scheduler's decision records
clock = time.monotonic

#: the armed sink's append; None while disarmed (every span site tests it)
emit = None

_ring: deque = deque()
_bound = threading.local()


def arm() -> None:
    """Start recording into a fresh sink (an earlier arming's spans are
    dropped)."""
    global emit, _ring
    _ring = deque()
    emit = _ring.append


def disarm() -> None:
    """Stop recording; ``spans()`` still returns what was recorded."""
    global emit
    emit = None


def spans() -> list[tuple]:
    """The recorded spans, in the order they ended."""
    return list(_ring)


def bind(tid, key) -> None:
    """Set the ``tid`` and ``key`` that code called from this thread gives
    its spans when it cannot know them itself (the train step's)."""
    _bound.tid_key = (tid, key)


def bound() -> tuple:
    """``(tid, key)`` as this thread's last ``bind`` set them, or
    ``(None, None)``."""
    return getattr(_bound, "tid_key", (None, None))
