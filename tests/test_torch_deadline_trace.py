"""The port's copies of the deadline arbiter (core/deadline.py) and the trace
recorder (trace/) under the port's serving engine: each request's deadline
is posted and retired, and the trace holds the request records in the order
the JAX engine records them for the same request stream."""

import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke as j_get_smoke
from repro.core.deadline import DeadlineArbiter as JDeadlineArbiter
from repro.core.policies import SchedCoop as JSchedCoop
from repro.core.threads import UsfRuntime as JUsfRuntime
from repro.core.topology import Topology as JTopology
from repro.models.base import init_tree as j_init_tree
from repro.models.registry import build_model as j_build_model
from repro.serve.engine import InferenceServer as JInferenceServer
from repro.serve.engine import Request as JRequest
from repro.trace import TraceRecorder as JTraceRecorder
from repro_torch.configs.base import get_smoke
from repro_torch.core.deadline import DeadlineArbiter
from repro_torch.core.policies import SchedCoop
from repro_torch.core.scheduler import (REC_DL_POST, REC_DL_RETIRE,
                                        REC_REQ_DONE, REC_REQUEST)
from repro_torch.core.threads import UsfRuntime
from repro_torch.core.topology import Topology
from repro_torch.models.base import params_from_numpy
from repro_torch.serve.engine import InferenceServer, Request
from repro_torch.trace import TraceRecorder, load_trace

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

ARCH = "smollm_360m"
REQUEST_CODES = (REC_REQUEST, REC_REQ_DONE, REC_DL_POST, REC_DL_RETIRE)


def _serve(pkg, prompts, max_new, slo, path):
    """Serve ``prompts`` (all queued before the worker starts, so the
    engine admits them in a fixed order) on a runtime with a deadline
    arbiter and an armed recorder. Returns the outputs, the request-level
    records as (code, request index or job), the arbiter and the trace
    file's records."""
    (Runtime, Topo, Coop, Arbiter, Recorder, Server, Req, cfg, extra) = pkg
    pol = Coop(quantum=0.05)
    usf = Runtime(Topo(2, 1), pol, arbiter=Arbiter(pol))
    rec = Recorder(path)
    try:
        rec.attach_runtime(usf)
        server = Server("srv", cfg, usf, max_batch=2, max_len=16, **extra)
        reqs = [server.submit(Req(tokens=list(p), max_new=max_new,
                                  deadline=time.monotonic() + slo))
                for p in prompts]
        server.start()
        for r in reqs:
            assert r.done.wait(timeout=120.0), "request timed out"
        server.stop()
    finally:
        rec.close()
        usf.shutdown(timeout=5.0)
    index = {r.rid: i for i, r in enumerate(reqs)}
    _, records = load_trace(str(path))
    seq = [(code, index[a] if code in (REC_REQUEST, REC_REQ_DONE) else "job")
           for _, code, a, _ in records if code in REQUEST_CODES]
    return [list(r.output) for r in reqs], seq, usf.sched.arbiter, records


@pytest.mark.parametrize("slo", [60.0, -1.0], ids=["ahead", "overdue"])
def test_deadlines_posted_retired_and_traced_as_the_jax_engine(slo, tmp_path):
    rng = np.random.default_rng(11)
    jcfg, tcfg = j_get_smoke(ARCH), get_smoke(ARCH)
    prompts = [rng.integers(0, jcfg.vocab, size=n).tolist() for n in (3, 6, 1, 4)]
    params = jax.tree_util.tree_map(np.asarray, j_init_tree(
        jax.random.PRNGKey(0), j_build_model(jcfg).param_specs(),
        jcfg.param_dtype))

    want, want_seq, _, _ = _serve(
        (JUsfRuntime, JTopology, JSchedCoop, JDeadlineArbiter, JTraceRecorder,
         JInferenceServer, JRequest, jcfg, {}),
        prompts, 4, slo, tmp_path / "jax.jsonl")
    got, seq, arbiter, records = _serve(
        (UsfRuntime, Topology, SchedCoop, DeadlineArbiter, TraceRecorder,
         InferenceServer, Request, tcfg,
         {"device": "cpu", "params": params_from_numpy(params, device="cpu")}),
        prompts, 4, slo, tmp_path / "torch.jsonl")

    assert got == want
    # every posted deadline was retired
    assert arbiter._posted == {}
    n = len(prompts)
    for code in REQUEST_CODES:
        assert sum(c == code for c, _ in seq) == n, code
    assert sorted(i for c, i in seq if c == REC_REQUEST) == list(range(n))
    assert sorted(i for c, i in seq if c == REC_REQ_DONE) == list(range(n))
    assert seq == want_seq
    # the recorder streamed the scheduler's decisions too
    assert len(records) > len(seq)
