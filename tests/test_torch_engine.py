"""The port's serving engine under the port's USF runtime, and its parity
with the JAX engine on the same weights."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke as j_get_smoke
from repro.core.policies import SchedCoop as JSchedCoop
from repro.core.task import Job as JJob
from repro.core.threads import UsfRuntime as JUsfRuntime
from repro.core.topology import Topology as JTopology
from repro.models.base import init_tree as j_init_tree
from repro.models.registry import build_model as j_build_model
from repro.serve.engine import InferenceServer as JInferenceServer
from repro.serve.engine import Request as JRequest
from repro_torch.configs.base import get_smoke
from repro_torch.core.policies import SchedCoop
from repro_torch.core.task import Job
from repro_torch.core.threads import UsfRuntime
from repro_torch.core.topology import Topology
from repro_torch.models.base import params_from_numpy
from repro_torch.serve.engine import Gateway, InferenceServer, Request

ROOT = Path(__file__).resolve().parents[1]


def test_serving_engine_under_usf():
    """Twin of test_substrates.test_serving_engine_under_usf on the port:
    two oversubscribed model servers + gateway on a 2-slot runtime."""
    usf = UsfRuntime(Topology(2, 1), SchedCoop(quantum=0.05))
    try:
        s1 = InferenceServer("srv-a", get_smoke("smollm_360m"), usf,
                             max_batch=2, max_len=32, nice=10, device="cpu")
        s2 = InferenceServer("srv-b", get_smoke("qwen1_5_110b"), usf,
                             max_batch=2, max_len=32, nice=10, device="cpu")
        s1.start()
        s2.start()
        gw = Gateway(usf, [s1, s2])
        results = []

        def client():
            results.append(gw.handle([5, 6, 7], max_new=3))

        tasks = [usf.create(client, job=gw.job, name=f"client{i}")
                 for i in range(3)]
        for t in tasks:
            assert usf.join(t, timeout=120.0), "client timed out"
        assert len(results) == 3
        assert s1.served == 3 and s2.served == 3
        for r in results:
            assert r["latency"] > 0
            assert all(len(o) == 3 for o in r["outputs"].values())

        # live policy change without drain
        lease1 = s1.set_policy(SchedCoop(quantum=0.02), share=2.0)
        assert lease1.group.dedicated and s1.job.lease is lease1
        lease2 = s2.set_policy(None)
        assert not lease2.group.dedicated
        t = usf.create(client, job=gw.job, name="client-post-swap")
        assert usf.join(t, timeout=120.0), "post-swap client timed out"
        assert s1.served == 4 and s2.served == 4

        s1.stop()
        s2.stop()
    finally:
        usf.shutdown(timeout=5.0)


def _serve(usf, server, prompts, max_new, request_cls, job_cls):
    server.start()
    reqs = [server.submit(request_cls(tokens=list(p), max_new=max_new))
            for p in prompts]
    out = []

    def client():
        for r in reqs:
            r.done.wait()
            out.append(list(r.output))

    t = usf.create(client, job=job_cls("client"), name="client")
    assert usf.join(t, timeout=120.0), "client timed out"
    server.stop()
    return out


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen1_5_110b"])
def test_engine_matches_jax_engine_token_for_token(arch):
    """Same carried weights, same requests (more than the batch holds, so
    slots are reused): the greedy outputs are identical."""
    rng = np.random.default_rng(4)
    jcfg, tcfg = j_get_smoke(arch), get_smoke(arch)
    prompts = [rng.integers(0, jcfg.vocab, size=n).tolist() for n in (3, 6, 1, 4)]
    params = jax.tree_util.tree_map(np.asarray, j_init_tree(
        jax.random.PRNGKey(0), j_build_model(jcfg).param_specs(),
        jcfg.param_dtype))

    jusf = JUsfRuntime(JTopology(2, 1), JSchedCoop(quantum=0.05))
    try:
        want = _serve(jusf, JInferenceServer("jax", jcfg, jusf, max_batch=2,
                                             max_len=16, seed=0),
                      prompts, 5, JRequest, JJob)
    finally:
        jusf.shutdown(timeout=5.0)
    usf = UsfRuntime(Topology(2, 1), SchedCoop(quantum=0.05))
    try:
        got = _serve(usf, InferenceServer("torch", tcfg, usf, max_batch=2,
                                          max_len=16, device="cpu",
                                          params=params_from_numpy(params)),
                     prompts, 5, Request, Job)
    finally:
        usf.shutdown(timeout=5.0)
    assert got == want
    assert all(len(o) == 5 for o in got)


def test_server_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    usf = UsfRuntime(Topology(1, 1), SchedCoop())
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceServer("srv", get_smoke("smollm_360m"), usf)
    finally:
        usf.shutdown(timeout=5.0)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
