"""Auto-checkpoint instrumentation: preemption points without application
changes.

The runtime can only deschedule a task at a *scheduling point* — a
blocking call or an explicit ``usf.checkpoint()``. A CPU-bound task that
does neither (the unmodified-library case the paper's §4.4 worries about)
holds its slot until it finishes, so a broker revoke or an elastic
``set_slot_target`` shrink lands with unbounded latency. This module
closes that gap for the dominant shape of such tasks in this repo —
Python loops driving jitted JAX compute — by interposing the checkpoint
fast path (two lock-free reads, see ``UsfRuntime.checkpoint``) at every
**dispatch boundary**: each call into a jitted step function is one
device-kernel launch, so checkpointing there bounds revoke-to-park
latency at roughly one dispatch interval without touching the
application's code. LibPreemptible (PAPERS.md) makes the same argument
for compiler-inserted preemption points; here the "compiler" is a
wrapper, because the dispatch boundary is already a function call.

Three tiers (see docs/PREEMPTION.md for the full delivery-latency
ladder):

* ``preemptible(fn, runtime=rt)`` / ``wrap_jit`` — wrap a (jitted)
  callable so every invocation passes through ``runtime.checkpoint()``
  first. Idempotent: wrapping a wrapped function returns it unchanged.
* ``maybe_checkpoint(rt, every=N)`` — a generation-counter tick for
  non-JAX hot loops: returns a ``tick()`` closure that counts calls and
  runs the checkpoint on every Nth, so loops too hot for a per-iteration
  checkpoint still reach one at a bounded period.
* ``preemptible_body(genfn, every=N)`` — the ``SimExecutor`` twin: wraps
  a generator task body so the sim's ``("checkpoint",)`` op is injected
  after every Nth yielded op. Instrumented thread bodies and their sim
  twins therefore hit checkpoints at the same logical boundaries, which
  keeps auto-checkpointed programs lockstep-testable on virtual time.

Every tier is safe to sprinkle unconditionally: ``UsfRuntime.checkpoint``
is a no-op from a plain (non-USF) thread and from free-running
(``gating=False``) tasks, and the sim's checkpoint op is a no-op unless a
preemption is pending — so library code instruments once and the same
code path serves gated runs, free-running baselines and unit tests.

Scoping note — the signal-based fallback we deliberately do NOT ship:
the classic alternative to cooperative points is asynchronous delivery
via ``pthread_kill`` + a ``SIGURG``-style handler (LibPreemptible's
kernel-bypass mode, and what an OS-level implementation would use). That
design is not implementable for this runtime's worker threads in
CPython: the interpreter delivers Python-level signal handlers **only on
the main thread** (``signal`` module contract — handlers raised in a
C-level handler on any thread are queued and executed by the main
interpreter loop), so a signal aimed at a worker mid-kernel would
deschedule *the main thread*, not the target. A C-extension handler
could run on the target thread but could not safely re-enter the
scheduler (no GIL guarantees inside a signal context, and XLA's runtime
is not async-signal-safe). The watchdog thread therefore remains the
backstop tier for code no wrapper can reach, and the auto-checkpoint
tier covers the dispatch-driven compute that dominates in practice.
"""

from __future__ import annotations

from typing import Any, Callable, Generator, Optional

from repro_torch.core import simtask as _st

__all__ = [
    "preemptible",
    "wrap_jit",
    "maybe_checkpoint",
    "preemptible_body",
]

#: marker attribute set on wrappers so re-wrapping is the identity
_MARK = "__usf_autockpt__"

#: jit-object attributes forwarded onto the wrapper so ``wrap_jit`` output
#: keeps the inspection surface callers use (AOT lowering, cache control)
_JIT_ATTRS = ("lower", "trace", "eval_shape", "clear_cache")


def _adopt_identity(wrapper: Callable, fn: Callable) -> None:
    """``functools.wraps`` minus the attributes jit function objects may
    not expose (PjitFunction has no ``__dict__`` to merge)."""
    for attr in ("__name__", "__qualname__", "__doc__", "__module__"):
        try:
            setattr(wrapper, attr, getattr(fn, attr))
        except AttributeError:
            pass
    wrapper.__wrapped__ = fn  # type: ignore[attr-defined]


def preemptible(fn: Callable, *, runtime: Any,
                every: int = 1) -> Callable:
    """Wrap ``fn`` so each call runs ``runtime.checkpoint()`` at entry —
    the dispatch boundary becomes a preemption point.

    ``every=N`` checkpoints on every Nth call instead (for dispatch loops
    whose per-call cost is so small the wrapper itself would show up; the
    counter is a plain int cell — a lost increment under thread races
    only defers one checkpoint, it never corrupts anything). Wrapping an
    already-wrapped callable returns it unchanged, so layered helpers can
    instrument defensively without stacking checkpoints.

    The wrapped function is identical to ``fn`` from a plain thread or a
    free-running task: ``checkpoint()`` no-ops there, so baselines run
    the same instrumented code as coordinated runs.
    """
    if getattr(fn, _MARK, False):
        return fn
    every = max(1, int(every))
    ckpt = runtime.checkpoint
    if every == 1:
        def wrapped(*args, **kwargs):
            ckpt()
            return fn(*args, **kwargs)
    else:
        gen = [0]

        def wrapped(*args, **kwargs):
            gen[0] += 1
            if gen[0] >= every:
                gen[0] = 0
                ckpt()
            return fn(*args, **kwargs)

    _adopt_identity(wrapped, fn)
    setattr(wrapped, _MARK, True)
    return wrapped


def wrap_jit(jitted: Callable, *, runtime: Any, every: int = 1) -> Callable:
    """``preemptible`` for ``jax.jit`` outputs: same checkpoint-at-entry
    wrapper, plus the jit object's AOT/cache surface (``lower``,
    ``trace``, ``eval_shape``, ``clear_cache``) forwarded onto the
    wrapper so call sites that lower or clear the underlying executable
    keep working."""
    wrapped = preemptible(jitted, runtime=runtime, every=every)
    if wrapped is jitted:  # already instrumented
        return jitted
    for attr in _JIT_ATTRS:
        target = getattr(jitted, attr, None)
        if target is not None:
            setattr(wrapped, attr, target)
    return wrapped


def maybe_checkpoint(runtime: Any, *, every: int = 64) -> Callable[[], None]:
    """Generation-counter checkpoint tier for non-JAX hot loops.

    Returns a ``tick()`` closure: each call bumps a counter and every
    ``every``-th runs ``runtime.checkpoint()``. This replaces the
    hand-rolled ``if n % K == 0: rt.checkpoint()`` idiom with one object
    a library can create unconditionally — like the wrapper tiers it is
    a no-op outside a gated USF task."""
    every = max(1, int(every))
    ckpt = runtime.checkpoint
    gen = [0]

    def tick() -> None:
        gen[0] += 1
        if gen[0] >= every:
            gen[0] = 0
            ckpt()

    return tick


def preemptible_body(genfn: Callable[..., Generator], *,
                     every: int = 1) -> Callable[..., Generator]:
    """SimExecutor twin of ``preemptible``: wrap a generator task body so
    the sim's ``("checkpoint",)`` op is injected after every ``every``-th
    op the body yields.

    The injected op is the virtual-time analogue of the thread wrapper's
    checkpoint-at-dispatch: ``SimExecutor`` consumes a pending preemption
    there (or continues synchronously — a no-op costs no virtual time),
    so an instrumented body parks at the same logical boundaries in both
    executors. Send-values (``channel_get`` results) pass through to the
    inner generator untouched; checkpoint resumes never carry a value.
    Idempotent like the thread-side wrappers."""
    if getattr(genfn, _MARK, False):
        return genfn
    every = max(1, int(every))

    def wrapped(*args, **kwargs) -> Generator:
        inner = genfn(*args, **kwargs)
        n = 0
        sent: Optional[Any] = None
        while True:
            try:
                op = inner.send(sent)
            except StopIteration:
                return
            sent = yield op
            n += 1
            if n % every == 0:
                yield _st.checkpoint()  # injected dispatch boundary

    _adopt_identity(wrapped, genfn)
    setattr(wrapped, _MARK, True)
    return wrapped
