"""The port's multi-process serving (repro_torch.serve.multiproc) on the CPU:
twins of tests/test_multiproc_serving.py's cases with ``device="cpu"``, a
child's greedy tokens against an in-process server on the same seed, and a
child that finds no card. Two server processes at most are alive at once."""

import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke
from repro_torch.core.policies import SchedCoop
from repro_torch.core.threads import UsfRuntime
from repro_torch.core.topology import Topology
from repro_torch.serve.engine import InferenceServer, Request
from repro_torch.serve.multiproc import (MultiProcessGateway, ServerProcess,
                                         ServerProcessError)

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

ARCHS = {"srv-a": "smollm_360m", "srv-b": "qwen1_5_110b"}
READY_S = 120.0   # a child's spawn, torch import and smoke model build
CALL_S = 120.0    # one fanned-out request


def _gateway(**kw) -> MultiProcessGateway:
    opts = dict(coordinate=True, node_capacity=2, slots_per_server=2,
                max_batch=2, max_len=32, smoke=True, device="cpu")
    opts.update(kw)
    return MultiProcessGateway(ARCHS, **opts)


def _wait_until(cond, timeout, step=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


@pytest.mark.parametrize("coordinate", [True, False])
def test_multiprocess_gateway_serves(coordinate):
    """Requests fan out to every server process and join; with
    coordination the broker splits the node, without it the processes run
    free; both complete, and each child decodes one engine step a token."""
    gw = _gateway(coordinate=coordinate)
    try:
        gw.start(ready_timeout=READY_S)
        if coordinate:
            snap = gw.broker.snapshot()
            assert sorted(snap["workers"]) == ["srv-a", "srv-b"]
            assert sum(w["granted"] for w in snap["workers"].values()) == 2
        for _ in range(2):
            rec = gw.handle([5, 6, 7], max_new=3, timeout=CALL_S)
            assert rec["latency"] > 0
            assert sorted(rec["outputs"]) == ["srv-a", "srv-b"]
            for out in rec["outputs"].values():
                assert len(out) == 3
        assert len(gw.responses) == 2
        # a request alone in the batch: (prompt 3 - 1) + 3 new = 5 steps
        assert rec["steps"] == {"srv-a": 10, "srv-b": 10}
        # the kernels' wrappers count CUDA launches only
        assert all(set(n.values()) == {0} for n in rec["launches"].values())
        if coordinate:
            assert all(s.served == 2 for s in gw.servers)
    finally:
        gw.stop()
    assert not any(s.alive() for s in gw.servers)


def test_dead_server_process_surfaces_not_hangs():
    """Unsupervised (fail fast): a server process killed mid-flight raises
    ServerProcessError at the caller, and under coordination its node lease
    is reclaimed."""
    gw = _gateway(supervise=False)
    try:
        gw.start(ready_timeout=READY_S)
        gw.handle([5, 6], max_new=2, timeout=CALL_S)  # warm + sane
        victim = gw.servers[0]
        victim._proc.kill()
        victim._proc.join(10.0)
        with pytest.raises((ServerProcessError, TimeoutError)):
            gw.handle([5, 6], max_new=2, timeout=60.0)
        assert _wait_until(
            lambda: list(gw.broker.snapshot()["workers"]) == ["srv-b"], 10.0)
    finally:
        gw.stop()


def test_supervisor_restarts_dead_server_then_breaker_benches_crashloop():
    """A killed server is respawned (capped backoff) and serves again; a
    crash-looping server trips the circuit breaker: the slot is marked
    failed in snapshots and requests keep routing to the survivor."""
    gw = _gateway(supervise=True, max_restarts=2, restart_window=600.0,
                  restart_backoff=(0.1, 0.4), poll_interval=0.1)
    try:
        gw.start(ready_timeout=READY_S)
        gw.handle([5, 6], max_new=2, timeout=CALL_S)  # warm + sane
        victim = gw.servers[0]

        # heal: a dead server is restarted and serves again
        victim._proc.kill()
        assert _wait_until(lambda: victim.restarts >= 1 and victim.alive(),
                           timeout=READY_S)
        rec = gw.handle([5, 6], max_new=2, timeout=CALL_S)
        assert sorted(rec["outputs"]) == ["srv-a", "srv-b"]
        assert rec["retried"] == {}
        snap = gw.snapshot()
        assert snap["servers"]["srv-a"]["restarts"] >= 1
        assert snap["servers"]["srv-a"]["failed"] is False

        # crash loop: every respawn now dies during init, so the window
        # fills and the breaker opens
        victim.spec["arch"] = "no-such-arch"
        victim._proc.kill()
        assert _wait_until(lambda: victim.failed, timeout=READY_S)
        assert gw.snapshot()["servers"]["srv-a"]["failed"] is True
        rec = gw.handle([5, 6], max_new=2, timeout=CALL_S)
        assert list(rec["outputs"]) == ["srv-b"]  # the survivor serves
    finally:
        gw.stop()


def test_inflight_request_retried_once_on_survivor():
    """A request in flight on a dying server is retried once on a survivor
    and recorded under the dead server's key with a ``retried_on`` marker,
    instead of surfacing ServerProcessError."""
    # quiescent supervisor (long poll): the restart machinery must not
    # race the in-flight window pinned below
    gw = _gateway(supervise=True, poll_interval=60.0)
    try:
        gw.start(ready_timeout=READY_S)
        gw.handle([5, 6], max_new=2, timeout=CALL_S)  # warm + sane
        victim = gw.servers[0]
        victim._proc.kill()
        victim._proc.join(30.0)
        # the gateway targets the (already dead) server exactly once more,
        # so the submitted request is in flight on a dead process when the
        # collector reaches it
        forced = []
        real_alive = victim.alive

        def one_last_alive():
            if not forced:
                forced.append(1)
                return True
            return real_alive()

        victim.alive = one_last_alive
        try:
            rec = gw.handle([5, 6], max_new=2, timeout=CALL_S)
        finally:
            victim.alive = real_alive
        assert sorted(rec["outputs"]) == ["srv-a", "srv-b"]
        assert rec["retried"] == {"srv-a": "srv-b"}
    finally:
        gw.stop()


def _in_process_tokens(arch, prompts, max_new):
    """Greedy tokens of an in-process server (seed 0, as in the children),
    one request at a time, on one intra-op thread as a CPU child runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    usf = UsfRuntime(Topology(2, 1), SchedCoop(quantum=0.05))
    try:
        server = InferenceServer("local", get_smoke(arch), usf, max_batch=2,
                                 max_len=32, device="cpu")
        server.start()
        out = []
        for p in prompts:
            req = server.submit(Request(tokens=list(p), max_new=max_new))
            assert req.done.wait(timeout=CALL_S), "in-process request timed out"
            out.append(list(req.output))
        server.stop()
    finally:
        usf.shutdown(timeout=5.0)
        torch.set_num_threads(threads)
    return out


def test_child_tokens_equal_in_process_server():
    """Same seed, same shapes, same thread count: each child's greedy
    tokens equal an in-process server's (which tests/test_torch_engine.py
    holds against the JAX engine token for token)."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (5, 9, 2)]
    gw = _gateway()
    try:
        gw.start(ready_timeout=READY_S)
        got = {name: [] for name in ARCHS}
        for p in prompts:
            rec = gw.handle(p, max_new=6, timeout=CALL_S)
            for name, out in rec["outputs"].items():
                got[name].append(out)
    finally:
        gw.stop()
    for name, arch in ARCHS.items():
        assert got[name] == _in_process_tokens(arch, prompts, 6), name
        assert all(len(o) == 6 for o in got[name])


def test_child_without_a_card_raises_not_runs_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    s = ServerProcess("srv", "smollm_360m", device=None)
    try:
        with pytest.raises(ServerProcessError, match="no CUDA device"):
            s.start(ready_timeout=READY_S)
    finally:
        s.stop()
    assert not s.alive()
