"""Oversubscribed serving engine (the paper's §5.5 scenario) on torch.

Port of ``repro/serve/engine.py`` with the same scheduling behaviour. Each
``InferenceServer`` is a USF *job* whose worker task runs a
continuous-batching decode loop over a slot-based KV cache; every wait
(request-queue get, batch formation) is an intercepted USF blocking point,
and every call into the decode step is a preemption point through
``core/autockpt.py``. A ``Gateway`` fans each request out to several
servers and joins the responses.

Differences from the JAX engine, all in how the device is driven:

* the step updates the KV cache in place (the JAX step donates it);
* admitting a request into a slot resets that slot's row of the cache
  (``LM.reset_slot``), so a recurrent state (mamba2, RG-LRU) starts
  fresh; the JAX engine reuses the previous request's state there;
* the per-step device wait is one synchronising copy of the argmax tokens
  to the host;
* weights are cast to the compute dtype once, at construction;
* decode attention runs the hand-written flash-decode kernel on CUDA;
* a model whose frontend is not ``token`` (qwen2-vl's patches) is refused
  at construction: the engine feeds token ids to the decode step, which
  such a model reads as embeddings (the JAX engine fails inside its
  worker);
* with the span sink armed (``runtime/spans.py``) each engine step records
  ``engine.step`` (its active slots after admit) holding ``engine.admit``,
  ``engine.dispatch`` (the token and position copies and the step's call)
  and ``engine.sync`` (the argmax copy to the host), and each blocking
  wait with no active slot ``engine.idle``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.autockpt import preemptible
from repro_torch.core.policies import Policy, SchedCoop
from repro_torch.core.scheduler import REC_REQ_DONE, REC_REQUEST
from repro_torch.core.sync import CoopChannel, CoopEvent
from repro_torch.core.task import Job
from repro_torch.core.threads import UsfRuntime, UsfTaskError
from repro_torch.launch.inputs import make_decode_inputs
from repro_torch.models.base import init_tree, resolve_device
from repro_torch.models.registry import build_model
from repro_torch.runtime import spans
from repro_torch.runtime.sharding import Sharder
from repro_torch.train.step import make_serve_step

_RID = itertools.count()


@dataclasses.dataclass
class Request:
    tokens: list[int]
    max_new: int = 8
    rid: int = dataclasses.field(default_factory=lambda: next(_RID))
    arrival: float = 0.0
    started: float = 0.0
    finished: float = 0.0
    #: absolute SLO deadline (``time.monotonic`` domain); None = best-effort
    deadline: Optional[float] = None
    output: list[int] = dataclasses.field(default_factory=list)
    done: Optional[CoopEvent] = None
    #: arbiter deadline token while posted (set by ``submit``)
    _dl_token: Optional[int] = None

    @property
    def latency(self) -> float:
        return self.finished - self.arrival

    @property
    def missed(self) -> bool:
        """True iff the request had an SLO and finished past it."""
        return (self.deadline is not None and self.finished > 0.0
                and self.finished > self.deadline)


class InferenceServer:
    """One model server (a Job): continuous batching over `max_batch` KV
    slots; requests are prefilled teacher-forced through the decode path
    and then generated greedily.

    ``device=None`` means the CUDA card. ``params`` (the model's param tree
    on ``device``) replaces the seeded initialisation."""

    def __init__(self, name: str, cfg, usf: UsfRuntime, *,
                 max_batch: int = 2, max_len: int = 64, seed: int = 0,
                 nice: int = 0, share: Optional[float] = None,
                 policy: Optional[Policy] = None, auto_ckpt: bool = True,
                 device=None, params: Optional[dict] = None):
        if cfg.frontend != "token":
            raise ValueError(
                f"{cfg.name}: the engine serves token ids, and this model's "
                f"{cfg.frontend} frontend takes precomputed embeddings; run "
                f"its decode step (make_serve_step) on [B,1,Din] embeddings")
        self.name = name
        self.cfg = cfg
        self.usf = usf
        self.device = resolve_device(device)
        self.job = Job(name, nice=nice, share=share)
        self._policy = policy
        self.lease = None  # set on start()
        self.max_batch = max_batch
        self.max_len = max_len
        self.queue = CoopChannel(usf)
        self.model = build_model(cfg)
        self.sharder = Sharder(None)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_tree(gen, self.model.param_specs(), cfg.param_dtype,
                               self.device)
        self.params = self.model.compute_params(params)
        self._step = make_serve_step(self.model, self.sharder)
        if auto_ckpt:
            # every decode dispatch is a preemption point: a broker revoke
            # or elastic shrink parks this worker within ~one engine step
            # even when the batch never drains (docs/PREEMPTION.md tier 3)
            self._step = preemptible(self._step, runtime=usf)
        self._task = None
        self._stop = False
        self.served = 0
        #: engine steps taken (one decode token for every slot)
        self.steps = 0

    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> Request:
        req.done = req.done or CoopEvent(self.usf)
        req.arrival = req.arrival or time.monotonic()
        if req.deadline is not None:
            # surface the SLO to the job-level arbiter (a DeadlineArbiter
            # folds it into its grant order; the base SlotArbiter has no
            # post_deadline and the request degrades to best-effort)
            post = getattr(self.usf.sched.arbiter, "post_deadline", None)
            if post is not None:
                req._dl_token = post(self.job, req.deadline)
        rec = self.usf.sched._rec
        if rec is not None:
            rec((self.usf.sched.clock(), REC_REQUEST, req.rid,
                 (self.job.jid, req.deadline)))
        self.queue.put(req)
        return req

    def _retire(self, req: Request) -> None:
        rec = self.usf.sched._rec
        if rec is not None:
            rec((self.usf.sched.clock(), REC_REQ_DONE, req.rid, req.latency))
        if req._dl_token is not None:
            retire = getattr(self.usf.sched.arbiter, "retire_deadline", None)
            if retire is not None:
                retire(self.job, req._dl_token)
            req._dl_token = None

    def start(self) -> None:
        # the worker starts through the shared default group and is then
        # re-homed live into its own arbiter group (see the JAX engine)
        self._task = self.usf.create(self._serve_loop, job=self.job,
                                     name=f"{self.name}-worker")
        if self.job.lease is None or not self.job.lease.group.dedicated:
            self.lease = self.usf.attach(
                self.job, policy=self._policy or SchedCoop(),
                share=self.job.share,
            )

    def set_policy(self, policy: Optional[Policy], *,
                   share: Optional[float] = None):
        """Live re-home the server without draining its decode loop: a
        fresh dedicated intra-job policy swaps in place, or ``policy=None``
        demotes the server into the shared default group."""
        if policy is None:
            self.lease = self.usf.demote(self.job, share=share)
        else:
            self.lease = self.usf.attach(
                self.job, policy=policy,
                share=share if share is not None else self.job.share,
            )
        return self.lease

    def stop(self) -> None:
        self._stop = True
        self.queue.put(None)  # wake the worker

    # ------------------------------------------------------------------ #
    def _serve_loop(self) -> None:
        cfg = self.cfg
        B = self.max_batch
        dev = self.device
        cache, _, _ = make_decode_inputs(
            cfg, B, self.max_len, torch.Generator(device=dev).manual_seed(1), dev)
        active: list[Optional[Request]] = [None] * B
        pos = np.zeros(B, np.int64)
        remaining = np.zeros(B, np.int64)
        pending_tokens: list[list[int]] = [[] for _ in range(B)]
        cur = np.zeros(B, np.int64)
        task = self.usf.current_task()
        tid = task.tid if task is not None else None
        clock = spans.clock

        while not self._stop:
            emit = spans.emit
            if emit is not None:
                t0 = clock()
            # admit requests into free slots (continuous batching)
            for i in range(B):
                if active[i] is None:
                    if any(a is not None for a in active):
                        req = self.queue.try_get()
                    else:  # block only when fully idle
                        req = self.queue.get()
                        if emit is not None:
                            t = clock()
                            emit((t0, t, "engine.idle", tid, (self.name, self.steps), None))
                            t0 = t
                    if req is None:
                        if self._stop:
                            return
                        continue
                    req.started = time.monotonic()
                    active[i] = req
                    self.model.reset_slot(cache, i)
                    pos[i] = 0
                    remaining[i] = req.max_new
                    pending_tokens[i] = list(req.tokens)
                    cur[i] = pending_tokens[i].pop(0)
            if all(a is None for a in active):
                continue

            # one engine step: each active slot advances one token
            if emit is not None:
                key = (self.name, self.steps)
                t1 = clock()
                emit((t0, t1, "engine.admit", tid, key, None))
            toks = torch.from_numpy(cur.astype(np.int32)).to(dev)
            p = torch.from_numpy(pos.astype(np.int32)).to(dev)
            if cfg.mrope_sections is not None:
                p = p.expand(3, B)  # M-RoPE: three equal position streams
            logits, cache = self._step(self.params, cache, toks, p)
            if emit is not None:
                t2 = clock()
                emit((t1, t2, "engine.dispatch", tid, key, None))
            # the device wait: one synchronising copy of the next tokens
            nxt = logits.argmax(dim=-1).cpu().numpy()
            if emit is not None:
                emit((t2, clock(), "engine.sync", tid, key, None))
                n_active = sum(a is not None for a in active)
            self.steps += 1

            for i in range(B):
                req = active[i]
                if req is None:
                    continue
                pos[i] += 1
                if pending_tokens[i]:
                    cur[i] = pending_tokens[i].pop(0)  # still prefilling
                    continue
                req.output.append(int(nxt[i]))
                cur[i] = int(nxt[i])
                remaining[i] -= 1
                if remaining[i] <= 0 or pos[i] >= self.max_len - 1:
                    req.finished = time.monotonic()
                    self.served += 1
                    self._retire(req)
                    req.done.set()
                    active[i] = None
            if emit is not None:
                emit((t0, clock(), "engine.step", tid, key, n_active))


class Gateway:
    """Fans each request out to all servers; joins all responses (§5.5)."""

    def __init__(self, usf: UsfRuntime, servers: list[InferenceServer],
                 *, nice: int = 0, share: Optional[float] = None,
                 policy: Optional[Policy] = None):
        self.usf = usf
        self.servers = servers
        self.job = Job("gateway", nice=nice, share=share)
        # the gateway gets its own lease too (nice 0 -> heaviest share by
        # default, mirroring the paper's microservices priority setup)
        self.lease = usf.attach(self.job, policy=policy or SchedCoop(),
                                share=share)
        self.responses: list[dict] = []

    def _check_servers(self) -> None:
        """A dead server worker would leave fanned-out requests pending
        forever: surface its task exception to the caller instead."""
        for s in self.servers:
            t = s._task
            if t is not None and getattr(t, "_exc", None) is not None:
                raise UsfTaskError(t, t._exc)

    def handle(self, tokens: list[int], max_new: int = 4,
               timeout: Optional[float] = None,
               slo: Optional[float] = None) -> dict:
        """Runs on the caller's USF task: submit to every server, wait all.

        Polls the response events so a crashed server worker raises
        ``UsfTaskError`` here rather than hanging the request; ``timeout``
        (wall seconds, whole fan-out) raises ``TimeoutError``. ``slo``
        (relative seconds) stamps every fanned request with an absolute
        deadline that a deadline-aware arbiter folds into its grant order;
        misses are recorded, never enforced."""
        t0 = time.monotonic()
        deadline = None if timeout is None else t0 + timeout
        dl = None if slo is None else t0 + slo
        reqs = []
        for s in self.servers:
            r = Request(tokens=list(tokens), max_new=max_new, arrival=t0,
                        deadline=dl)
            s.submit(r)
            reqs.append(r)
        for r in reqs:
            while True:
                poll = 0.5
                if deadline is not None:
                    poll = min(poll, max(deadline - time.monotonic(), 0.0))
                if r.done.wait(timeout=poll):
                    break
                self._check_servers()
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"gateway fan-out exceeded {timeout}s "
                        f"(request {r.rid})"
                    )
        rec = {
            "latency": time.monotonic() - t0,
            "per_server": {s.name: r.latency for s, r in zip(self.servers, reqs)},
            "outputs": {s.name: list(r.output) for s, r in zip(self.servers, reqs)},
        }
        if slo is not None:
            rec["slo"] = slo
            rec["missed"] = any(r.missed for r in reqs)
        self.responses.append(rec)
        return rec
