"""Cooperative synchronization primitives — the extended glibc APIs (§4.3.4).

Each primitive follows the paper's Listing 1 pattern: contended tasks are
placed in a spinlock-protected per-object FIFO wait queue, then paused via
the runtime (nosv_pause); the release path dequeues one waiter and submits
it to the scheduler (nosv_submit), transferring ownership where applicable.

Every primitive supports MIXED use: gated USF tasks park via the scheduler
(releasing their slot), while plain threads (the main thread, non-USF
helpers, or everything in the free-running Linux-baseline mode) wait on an
embedded Event — both against the SAME state, so a release from either
side wakes either kind of waiter. This mirrors glibcv, where USF and
non-USF threads share the same pthread objects.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Optional, Union

from repro_torch.core.task import Task
from repro_torch.core.threads import UsfRuntime


class _Waiter:
    """Either a gated task (paused via USF) or a plain-thread event."""

    __slots__ = ("task", "event")

    def __init__(self, task: Optional[Task]):
        self.task = task
        self.event = None if task is not None else threading.Event()

    def wake(self, rt: UsfRuntime) -> None:
        if self.task is not None:
            rt.ready(self.task)
        else:
            self.event.set()

    def wait(self, rt: UsfRuntime) -> None:
        if self.task is not None:
            rt.pause()
        else:
            self.event.wait()


def _gated_task(rt: UsfRuntime) -> Optional[Task]:
    return rt.current_task() if rt.gating else None


_HANDOFF = object()  # ownership in flight between unlock() and the waiter


class CoopMutex:
    """pthread_mutex with FIFO handoff (paper Listing 1)."""

    def __init__(self, rt: UsfRuntime):
        self._rt = rt
        self._spin = threading.Lock()
        self._owner: Optional[object] = None  # Task | thread ident | _HANDOFF
        self._queue: Deque[_Waiter] = deque()

    def _me(self):
        task = _gated_task(self._rt)
        return task if task is not None else threading.get_ident()

    def lock(self, timeout: Optional[float] = None) -> bool:
        """Acquire; returns True. With ``timeout`` (seconds) returns False
        if ownership was not handed over in time — consistent with
        ``CoopEvent.wait(timeout)``, for gated tasks (a timer on the
        runtime's watchdog heap withdraws the waiter and resubmits the
        task) and plain threads (timed wait on the embedded Event) alike.
        An unlock racing the expiry is benign: whichever side dequeues the
        waiter first decides, and a handoff that already reserved us wins
        (the lock is held — slightly late beats released-to-nobody)."""
        task = _gated_task(self._rt)
        me = task if task is not None else threading.get_ident()
        with self._spin:
            if self._owner is None:
                self._owner = me
                return True
            if timeout is not None and timeout <= 0:
                return False
            w = _Waiter(task)
            self._queue.append(w)
        if timeout is None:
            w.wait(self._rt)
            with self._spin:  # handoff completed: claim ownership
                assert self._owner is _HANDOFF
                self._owner = me
            return True
        if task is None:  # plain thread: timed wait on the embedded Event
            if not w.event.wait(timeout):
                with self._spin:
                    try:
                        self._queue.remove(w)
                        return False
                    except ValueError:
                        pass  # unlock already reserved us: claim below
            with self._spin:
                assert self._owner is _HANDOFF
                self._owner = me
            return True
        # gated task: timed nosv_pause via the watchdog heap
        timed_out = [False]

        def expire() -> None:
            with self._spin:
                try:
                    self._queue.remove(w)
                except ValueError:
                    return  # unlock already reserved us (handoff in flight)
                timed_out[0] = True
            self._rt.ready(task)

        timer = self._rt.call_later(timeout, expire)
        w.wait(self._rt)
        timer.cancel()
        if timed_out[0]:
            return False
        with self._spin:
            assert self._owner is _HANDOFF
            self._owner = me
        return True

    def unlock(self) -> None:
        nxt: Optional[_Waiter] = None
        with self._spin:
            # equality, not identity: a plain-thread owner is a fresh int
            # from get_ident() per call (equal value, not the same object)
            if self._owner is _HANDOFF or self._owner != self._me():
                raise RuntimeError("unlock by non-owner")
            if self._queue:
                nxt = self._queue.popleft()
                self._owner = _HANDOFF  # reserved for the woken waiter
            else:
                self._owner = None
        if nxt is not None:
            nxt.wake(self._rt)

    def __enter__(self) -> "CoopMutex":
        self.lock()
        return self

    def __exit__(self, *exc) -> None:
        self.unlock()


class CoopCondVar:
    """pthread_cond: wait releases the mutex, re-acquires after notify."""

    def __init__(self, rt: UsfRuntime, mutex: CoopMutex):
        self._rt = rt
        self._mutex = mutex
        self._spin = threading.Lock()
        self._waiting: Deque[_Waiter] = deque()

    def wait(self) -> None:
        w = _Waiter(_gated_task(self._rt))
        with self._spin:
            self._waiting.append(w)
        self._mutex.unlock()
        w.wait(self._rt)
        self._mutex.lock()

    def notify(self, n: int = 1) -> None:
        woken: list[_Waiter] = []
        with self._spin:
            for _ in range(min(n, len(self._waiting))):
                woken.append(self._waiting.popleft())
        for w in woken:
            w.wake(self._rt)

    def notify_all(self) -> None:
        self.notify(1 << 30)


class CoopBarrier:
    """pthread_barrier: cooperative (blocking) flavour."""

    def __init__(self, rt: UsfRuntime, parties: int):
        assert parties >= 1
        self._rt = rt
        self._parties = parties
        self._spin = threading.Lock()
        self._count = 0
        self._waiting: Deque[_Waiter] = deque()

    def wait(self) -> None:
        w = _Waiter(_gated_task(self._rt))
        release: Optional[list[_Waiter]] = None
        with self._spin:
            self._count += 1
            if self._count == self._parties:
                self._count = 0
                release = list(self._waiting)
                self._waiting.clear()
            else:
                self._waiting.append(w)
        if release is not None:
            for other in release:
                other.wake(self._rt)
            return  # last arrival proceeds without blocking
        w.wait(self._rt)


class CoopSemaphore:
    def __init__(self, rt: UsfRuntime, value: int = 0):
        self._rt = rt
        self._spin = threading.Lock()
        self._value = value
        self._queue: Deque[_Waiter] = deque()

    def acquire(self) -> None:
        w = None
        with self._spin:
            if self._value > 0:
                self._value -= 1
                return
            w = _Waiter(_gated_task(self._rt))
            self._queue.append(w)
        w.wait(self._rt)

    def try_acquire(self) -> bool:
        with self._spin:
            if self._value > 0:
                self._value -= 1
                return True
            return False

    def release(self) -> None:
        nxt: Optional[_Waiter] = None
        with self._spin:
            if self._queue:
                nxt = self._queue.popleft()
            else:
                self._value += 1
        if nxt is not None:
            nxt.wake(self._rt)


class CoopEvent:
    """One-shot event (the serving engine's request-completion wait)."""

    def __init__(self, rt: UsfRuntime):
        self._rt = rt
        self._spin = threading.Lock()
        self._set = False
        self._waiting: Deque[_Waiter] = deque()

    def is_set(self) -> bool:
        return self._set

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Wait for the event; returns False on timeout (True otherwise).

        Works for both waiter kinds: plain threads time out on the embedded
        Event; gated tasks arm a timer on the runtime's watchdog heap that
        withdraws the waiter from the queue and resubmits the task (a timed
        nosv_pause — no per-call ``threading.Timer`` thread). A timer
        firing concurrently with ``set()`` is benign: whichever side
        dequeues the waiter first wakes it, the other finds it gone."""
        with self._spin:
            if self._set:
                return True
            task = _gated_task(self._rt)
            w = _Waiter(task)
            self._waiting.append(w)
        if task is None:
            if w.event.wait(timeout):
                return True
            with self._spin:  # withdraw so a later set() skips us
                try:
                    self._waiting.remove(w)
                except ValueError:
                    pass
            return self._set
        if timeout is None:
            w.wait(self._rt)
            return True
        timed_out = [False]

        def expire() -> None:
            with self._spin:
                try:
                    self._waiting.remove(w)
                except ValueError:
                    return  # set() already claimed this waiter
                timed_out[0] = True
            self._rt.ready(task)

        timer = self._rt.call_later(timeout, expire)
        self._rt.pause()
        timer.cancel()
        return self._set or not timed_out[0]

    def set(self) -> None:
        with self._spin:
            self._set = True
            woken = list(self._waiting)
            self._waiting.clear()
        for w in woken:
            w.wake(self._rt)


class CoopChannel:
    """FIFO message queue; ``get`` blocks cooperatively when empty (the
    poll/epoll analogue of §4.3.4 — the serving engine's request queue)."""

    def __init__(self, rt: UsfRuntime):
        self._rt = rt
        self._items: Deque = deque()
        self._sem = CoopSemaphore(rt, 0)
        self._spin = threading.Lock()

    def put(self, item) -> None:
        with self._spin:
            self._items.append(item)
        self._sem.release()

    def get(self):
        self._sem.acquire()
        with self._spin:
            return self._items.popleft()

    def try_get(self):
        """Non-blocking get (single-consumer safe)."""
        if self._sem.try_acquire():
            with self._spin:
                return self._items.popleft()
        return None

    def __len__(self) -> int:
        with self._spin:
            return len(self._items)


class BusyWaitBarrier:
    """A *busy-wait* barrier à la OpenBLAS/BLIS (§5.2) for the real-thread
    mode. ``yield_every=None`` reproduces the unmodified library (spins,
    burning its slot — can livelock a cooperative policy, §4.4);
    ``yield_every=k`` is the paper's one-line sched_yield adaptation.
    """

    def __init__(self, rt: UsfRuntime, parties: int, *,
                 yield_every: Optional[int] = 1, spin_ns: int = 1000):
        self._rt = rt
        self._parties = parties
        self._yield_every = yield_every
        self._spin_ns = spin_ns
        self._count = 0
        self._generation = 0
        self._spin = threading.Lock()

    def wait(self, *, max_spins: Optional[int] = None) -> None:
        with self._spin:
            my_gen = self._generation
            self._count += 1
            if self._count == self._parties:
                self._count = 0
                self._generation += 1
                return
        spins = 0
        gated = self._rt.gating and self._rt.current_task() is not None
        while True:
            with self._spin:
                if self._generation != my_gen:
                    return
            spins += 1
            if max_spins is not None and spins > max_spins:
                raise TimeoutError("busy-wait barrier exceeded max_spins")
            ye = self._yield_every
            if ye is not None and spins % max(ye, 1) == 0:
                if gated:
                    self._rt.yield_now()  # the §5.2 adaptation
                else:
                    time.sleep(0)  # sched_yield
            else:
                t_end = time.monotonic_ns() + self._spin_ns
                while time.monotonic_ns() < t_end:
                    pass
