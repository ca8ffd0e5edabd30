"""The port's engine serves the recurrent families: a slot's cache row is
reset when a request is admitted (``LM.reset_slot``), so every request is
decoded from a fresh state however the slots were used before.

The JAX engine keeps the previous request's recurrent state in a reused
slot (ROADMAP Queue 3), so the port is held against the JAX *model*'s
greedy decode of each request from a fresh cache, on the same carried
weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke as j_get_smoke
from repro.models.base import init_tree as j_init_tree
from repro.models.registry import build_model as j_build_model
from repro.runtime.sharding import Sharder as JSharder
from repro.train.step import make_serve_step as j_make_serve_step
from repro_torch.configs.base import get_smoke
from repro_torch.core.policies import SchedCoop
from repro_torch.core.task import Job
from repro_torch.core.threads import UsfRuntime
from repro_torch.core.topology import Topology
from repro_torch.launch.inputs import make_decode_inputs
from repro_torch.models.base import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import InferenceServer, Request

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

MAX_LEN, MAX_NEW = 16, 5


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ["smollm_360m", "h2o_danube_3_4b",
                                  "deepseek_moe_16b", "mamba2_2_7b",
                                  "recurrentgemma_9b"])
@pytest.mark.parametrize("slot", [0, 2])
def test_reset_slot_restores_a_fresh_row(arch, slot):
    """After ``reset_slot(cache, i)`` row ``i`` of every leaf equals a
    fresh cache's row, and the other rows are untouched. The batch axis of
    each leaf is read from the JAX model's cache specs."""
    cfg, B = get_smoke(arch), 3
    model = build_model(cfg)
    fresh, _, _ = make_decode_inputs(cfg, B, MAX_LEN, torch.Generator(), "cpu")
    cache, _, _ = make_decode_inputs(cfg, B, MAX_LEN, torch.Generator(), "cpu")
    gen = torch.Generator().manual_seed(3)
    for _, leaf in _leaves(cache):  # a used cache: every entry moved
        if leaf.dtype == torch.int32:
            leaf.copy_(torch.randint(0, 50, leaf.shape, generator=gen))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=gen) + 3)
    used = {path: leaf.clone() for path, leaf in _leaves(cache)}

    model.reset_slot(cache, slot)

    jspecs = j_build_model(j_get_smoke(arch)).cache_specs(B, MAX_LEN)
    paths = [path for path, _ in _leaves(cache)]
    assert paths == [path for path, _ in _leaves(fresh)]
    assert paths == [path for path, _ in _leaves(jspecs)]
    for path, leaf in _leaves(cache):
        axis = _get(jspecs, path).axes.index("kv_batch")
        rows = leaf.movedim(axis, 0)
        want_fresh = _get(fresh, path).movedim(axis, 0)[slot]
        want_used = used[path].movedim(axis, 0)
        torch.testing.assert_close(rows[slot], want_fresh, rtol=0, atol=0)
        for r in range(B):
            if r != slot:
                torch.testing.assert_close(rows[r], want_used[r], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["smollm_360m", "mamba2_2_7b",
                                  "recurrentgemma_9b"])
def test_attention_layers_counts_one_decode_attention_a_layer(arch):
    cfg = get_smoke(arch)
    model = build_model(cfg)
    n_pos = sum(leaf.shape[0] if leaf.ndim == 3 else 1
                for path, leaf in _leaves(make_decode_inputs(
                    cfg, 2, MAX_LEN, torch.Generator(), "cpu")[0])
                if path[-1] == "pos")
    assert model.attention_layers() == n_pos
    assert model.attention_layers() == {"smollm_360m": cfg.n_layers,
                                        "mamba2_2_7b": 0,
                                        "recurrentgemma_9b": 1}[arch]


def _jax_greedy(jcfg, jparams, prompt):
    """The JAX model's greedy decode of one request from a fresh cache, fed
    as the engine feeds it: the prompt a token a step, then its own
    argmax, until MAX_NEW tokens or the cache's last position."""
    jmodel = j_build_model(jcfg)
    step = jax.jit(j_make_serve_step(jmodel, JSharder(None)))
    cache = j_init_tree(jax.random.PRNGKey(1), jmodel.cache_specs(1, MAX_LEN),
                        jcfg.param_dtype)
    out, pending, pos = [], list(prompt), 0
    tok = pending.pop(0)
    while True:
        logits, cache = step(jparams, cache, jnp.asarray([tok], jnp.int32),
                             jnp.asarray([pos], jnp.int32))
        pos += 1
        if pending:
            tok = pending.pop(0)
            continue
        tok = int(np.asarray(logits).argmax(-1)[0])
        out.append(tok)
        if len(out) >= MAX_NEW or pos >= MAX_LEN - 1:
            return out


@pytest.mark.parametrize("max_batch", [1, 2])
@pytest.mark.parametrize("arch", ["mamba2_2_7b", "recurrentgemma_9b"])
def test_engine_decodes_each_request_from_a_fresh_state(arch, max_batch):
    """More requests than slots, so every slot is reused: each request's
    greedy tokens equal the JAX model's from a fresh cache."""
    rng = np.random.default_rng(5)
    jcfg, tcfg = j_get_smoke(arch), get_smoke(arch)
    prompts = [rng.integers(0, jcfg.vocab, size=n).tolist() for n in (4, 7, 2, 5, 3)]
    params = jax.tree_util.tree_map(np.asarray, j_init_tree(
        jax.random.PRNGKey(0), j_build_model(jcfg).param_specs(),
        jcfg.param_dtype))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = [_jax_greedy(jcfg, jparams, p) for p in prompts]

    usf = UsfRuntime(Topology(2, 1), SchedCoop(quantum=0.05))
    try:
        server = InferenceServer("torch", tcfg, usf, max_batch=max_batch,
                                 max_len=MAX_LEN, device="cpu",
                                 params=params_from_numpy(params, device="cpu"))
        server.start()
        reqs = [server.submit(Request(tokens=list(p), max_new=MAX_NEW))
                for p in prompts]
        got = []

        def client():
            for r in reqs:
                r.done.wait()
                got.append(list(r.output))

        t = usf.create(client, job=Job("client"), name="client")
        assert usf.join(t, timeout=120.0), "client timed out"
        server.stop()
    finally:
        usf.shutdown(timeout=5.0)
    assert server.served == len(prompts)
    assert got == want
    assert all(len(o) == MAX_NEW for o in got)
