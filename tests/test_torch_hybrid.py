"""Port parity for the hybrid family (recurrentgemma-9b smoke: one
superblock of (rec, rec, local attention) and two tail recurrent blocks):
rglru_block and rglru_decode (outputs and cache), the param and cache
specs, LM.forward and LM.decode_step against the JAX package on the same
numpy weights and inputs (the JAX init carried over by
``params_from_numpy``), and the forward against teacher-forced decode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke as j_get_smoke
from repro.models import rglru as jrg
from repro.models.base import init_tree as j_init_tree
from repro.models.registry import build_model as j_build_model
from repro.runtime.sharding import Sharder as JSharder
from repro.train.step import make_prefill_step as j_make_prefill_step
from repro.train.step import make_serve_step as j_make_serve_step
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.launch.inputs import make_decode_inputs
from repro_torch.models import rglru as trg
from repro_torch.models.base import init_tree, params_from_numpy, tree_leaves
from repro_torch.models.registry import build_model as t_build_model
from repro_torch.runtime.sharding import Sharder as TSharder
from repro_torch.train.step import make_prefill_step, make_serve_step

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

ARCH = "recurrentgemma_9b"
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    """Within ``tol`` of the output's scale: sums of terms of that size run
    in another order in each framework."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _configs(**kw):
    return (dataclasses.replace(j_get_smoke(ARCH), **kw),
            dataclasses.replace(t_get_smoke(ARCH), **kw))


def _randomize_rec(rec, rng):
    """Zero-initialised conv and gate biases would not exercise their path."""
    for key in ("conv_b", "ba", "bx"):
        rec[key] = rng.normal(scale=0.3, size=rec[key].shape).astype(np.float32)
    return rec


def _rec_params(jcfg, seed=0):
    return _randomize_rec(_np_tree(j_init_tree(jax.random.PRNGKey(seed),
                                               jrg.rglru_specs(jcfg))),
                          np.random.default_rng(seed))


def _weights(jcfg, seed=0):
    """The JAX init of the model as numpy arrays, the recurrent blocks'
    biases randomised, and wq, wk, wv rescaled to std 1/sqrt(d_model): the
    init's fan-in of wq [d,H,hd] and wk, wv [d,KV,hd] is H and KV (ROADMAP
    Queue 3), a near-hard attention that turns a last-bit difference
    between the frameworks into a visible logit change."""
    params = _np_tree(j_init_tree(jax.random.PRNGKey(seed),
                                  j_build_model(jcfg).param_specs(),
                                  jcfg.param_dtype))
    rng = np.random.default_rng(seed)
    blocks = [params["superblocks"]["rec1"], params["superblocks"]["rec2"],
              *params["tail"].values()]
    for block in blocks:
        _randomize_rec(block["rec"], rng)
    attn = params["superblocks"]["attn"]["attn"]
    for key, n in (("wq", jcfg.n_heads), ("wk", jcfg.n_kv_heads),
                   ("wv", jcfg.n_kv_heads)):
        attn[key] = attn[key] * np.float32(np.sqrt(n / jcfg.d_model))
    return params


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32),
            "positions": np.ascontiguousarray(
                np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)))}


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_block_matches_jax(dtype, with_h0):
    jcfg, tcfg = _configs()
    jdt, tdt, tol = DTYPES[dtype]
    params = _rec_params(jcfg)
    B, S = 2, 40
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    h0 = rng.normal(size=(B, jcfg.lru_width)).astype(np.float32) if with_h0 else None
    want, wh = jrg.rglru_block(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg, JSharder(None),
        jnp.asarray(x).astype(jdt), None if h0 is None else jnp.asarray(h0),
        return_state=True)
    got, gh = trg.rglru_block(
        params_from_numpy(params, device="cpu"), tcfg, TSharder(None),
        torch.from_numpy(x).to(tdt), None if h0 is None else torch.from_numpy(h0),
        return_state=True)
    assert got.dtype == tdt and gh.dtype == torch.float32
    _close(got, want, tol)
    _close(gh, wh, tol)


def _scan_inputs(jcfg, with_h0, seed=1):
    B, S = 2, 40
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, jcfg.lru_width)).astype(np.float32)
    h0 = rng.normal(size=(B, jcfg.lru_width)).astype(np.float32) if with_h0 else None
    return x, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_scan_matches_jax(dtype, with_h0):
    """The card's path of the scan (``gated_scan``: the gates, then K5's
    gated entry, here its plain version on CPU tensors) against the JAX
    model's ``rglru_scan`` on the same weights and inputs."""
    jcfg, tcfg = _configs()
    jdt, tdt, tol = DTYPES[dtype]
    params = _rec_params(jcfg)
    x, h0 = _scan_inputs(jcfg, with_h0)
    want, wh = jrg.rglru_scan(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                              jnp.asarray(x).astype(jdt),
                              None if h0 is None else jnp.asarray(h0))
    got, gh = trg.gated_scan(params_from_numpy(params, device="cpu"), tcfg,
                             torch.from_numpy(x).to(tdt),
                             None if h0 is None else torch.from_numpy(h0))
    assert got.dtype == tdt and gh.dtype == torch.float32
    _close(got, want, tol)
    _close(gh, wh, tol)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_scan_matches_the_cpu_scan(dtype, with_h0):
    """Both of the port's paths of the scan on the same inputs: the card's
    (the step recurrence from h0 on the gated entry's a and b) and the
    CPU's (h0 folded into the first step, the doubling scan). They share
    the gates and the formula, so they differ by the scans' fp32 order
    (2e-5) and, in bf16, by where y's one rounding lands (one bf16 ulp)."""
    jcfg, tcfg = _configs()
    _, tdt, _ = DTYPES[dtype]
    params = params_from_numpy(_rec_params(jcfg), device="cpu")
    x, h0 = _scan_inputs(jcfg, with_h0, seed=4)
    x = torch.from_numpy(x).to(tdt)
    h0 = None if h0 is None else torch.from_numpy(h0)
    got, gh = trg.gated_scan(params, tcfg, x, h0)
    want, wh = trg.rglru_scan(params, tcfg, x, h0)
    assert got.dtype == want.dtype == tdt
    tol = 2e-5 if dtype == "float32" else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(gh, wh, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_decode_matches_jax(dtype):
    jcfg, tcfg = _configs(compute_dtype=dtype)
    jdt, tdt, tol = DTYPES[dtype]
    params = _rec_params(jcfg)
    B = 2
    rng = np.random.default_rng(2)
    jcache = j_init_tree(jax.random.PRNGKey(1), jrg.rglru_cache_specs(jcfg, B))
    tcache = params_from_numpy(_np_tree(jcache), device="cpu")
    assert tcache["conv"].dtype == tdt and tcache["h"].dtype == torch.float32
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = params_from_numpy(params, device="cpu")
    for _ in range(6):  # past the conv buffer's 3 steps
        x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        jy, jcache = jrg.rglru_decode(jparams, jcfg, JSharder(None),
                                      jnp.asarray(x).astype(jdt), jcache)
        ty, same = trg.rglru_decode(tparams, tcfg, TSharder(None),
                                    torch.from_numpy(x).to(tdt), tcache)
        assert same is tcache  # updated in place
        _close(ty, jy, tol)
    for key in ("h", "conv"):
        _close(tcache[key], jcache[key], tol)


def test_block_state_equals_the_decode_state():
    """The full-sequence block's final state is the state the decode steps
    reach over the same inputs, and its outputs are theirs."""
    jcfg, cfg = _configs()
    params = params_from_numpy(_rec_params(jcfg), device="cpu")
    B, S = 2, 32
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, S, cfg.d_model)).astype(np.float32))
    y, h = trg.rglru_block(params, cfg, TSharder(None), x, return_state=True)
    cache = init_tree(torch.Generator(), trg.rglru_cache_specs(cfg, B), device="cpu")
    for t in range(S):
        yt, cache = trg.rglru_decode(params, cfg, TSharder(None), x[:, t:t + 1], cache)
        torch.testing.assert_close(yt[:, 0], y[:, t], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cache["h"], h, rtol=1e-4, atol=1e-4)


def test_param_specs_and_cache_specs_match_jax():
    jcfg, tcfg = _configs()
    jm, tm = j_build_model(jcfg), t_build_model(tcfg)
    tspecs = tm.param_specs()
    assert sorted(tspecs["tail"]) == ["0", "1"]
    assert sorted(tspecs["superblocks"]) == ["attn", "rec1", "rec2"]
    for jspecs, tsp in ((jm.param_specs(), tspecs),
                        (jm.cache_specs(2, 8), tm.cache_specs(2, 8))):
        jflat = jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda s: hasattr(s, "axes"))[0]
        tflat = tree_leaves(tsp)
        assert len(jflat) == len(tflat)
        assert [(s.shape, s.axes, s.init, s.dtype) for _, s in jflat] == [
            (s.shape, s.axes, s.init, s.dtype) for s in tflat]
    assert tcfg.param_count_analytic() == jcfg.param_count_analytic()


def test_forward_logits_match_jax():
    """S = 40, longer than the smoke's local_window of 16: the window cuts.
    The weights are the JAX init carried over unchanged, nested superblock
    stacks and string-keyed tail included."""
    jcfg, tcfg = _configs()
    params = _weights(jcfg)
    batch = _tokens(jcfg, 2, 40, seed=1)
    want = j_make_prefill_step(j_build_model(jcfg), JSharder(None))(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tmodel = t_build_model(tcfg)
    tparams = params_from_numpy(params, device="cpu")
    assert sorted(tparams["tail"]) == ["0", "1"]
    got = make_prefill_step(tmodel, TSharder(None))(
        tmodel.compute_params(tparams),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2, 40, jcfg.vocab)
    _close(got, want, 2e-5)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


def test_greedy_decode_matches_jax():
    """24 greedy steps: the 16-slot local-attention ring wraps."""
    jcfg, tcfg = _configs()
    B, steps, max_len = 2, 24, 32
    jmodel, tmodel = j_build_model(jcfg), t_build_model(tcfg)
    params = _weights(jcfg)
    jstep = jax.jit(j_make_serve_step(jmodel, JSharder(None)))
    tstep = make_serve_step(tmodel, TSharder(None))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = tmodel.compute_params(params_from_numpy(params, device="cpu"))
    jcache = j_init_tree(jax.random.PRNGKey(1), jmodel.cache_specs(B, max_len),
                         jcfg.param_dtype)
    tcache, _, _ = make_decode_inputs(tcfg, B, max_len, torch.Generator(), "cpu")
    assert tcache["superblocks"]["attn"]["k"].shape[2] == jcfg.local_window
    jtok = ttok = np.array([3, 7], np.int32)
    for t in range(steps):
        pos = np.full((B,), t, np.int32)
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(jtok), jnp.asarray(pos))
        tlog, tcache = tstep(tparams, tcache, torch.from_numpy(ttok),
                             torch.from_numpy(pos))
        _close(tlog, jlog, 2e-5)
        jtok = np.asarray(jlog).argmax(-1).astype(np.int32)
        ttok = tlog.argmax(-1).numpy().astype(np.int32)
        np.testing.assert_array_equal(ttok, jtok)
    for block in ("rec1", "rec2"):
        for key in ("h", "conv"):
            _close(tcache["superblocks"][block][key],
                   jcache["superblocks"][block][key], 2e-5)
    for i in ("0", "1"):
        _close(tcache["tail"][i]["h"], jcache["tail"][i]["h"], 2e-5)
    np.testing.assert_array_equal(tcache["superblocks"]["attn"]["pos"].numpy(),
                                  np.asarray(jcache["superblocks"]["attn"]["pos"]))


def test_prefill_agrees_with_teacher_forced_decode():
    """Logits of one forward at every position t equal the decode step's
    after feeding tokens 0..t; the 16-slot ring wraps at S = 40."""
    _, cfg = _configs()
    model = t_build_model(cfg)
    params = model.compute_params(params_from_numpy(_weights(j_get_smoke(ARCH)),
                                                    device="cpu"))
    B, S = 2, 40
    batch = {k: torch.from_numpy(v) for k, v in _tokens(cfg, B, S, seed=2).items()}
    prefill = make_prefill_step(model, TSharder(None))(params, batch)
    step = make_serve_step(model, TSharder(None))
    cache, _, _ = make_decode_inputs(cfg, B, S, torch.Generator(), "cpu")
    for t in range(S):
        logits, cache = step(params, cache, batch["tokens"][:, t],
                             torch.full((B,), t, dtype=torch.int32))
        want = prefill[:, t]
        torch.testing.assert_close(
            logits, want, rtol=2e-5, atol=2e-5 * max(1.0, want.abs().max().item()))


@pytest.mark.parametrize("width", [64, 256])
def test_bf16_prefill_decode_gap_is_the_reference_models(width):
    """In bf16 the forward and teacher-forced decode round in different
    orders, and the JAX model's own two paths differ by more than 2e-2 of
    the largest logit (ROADMAP Queue 3). The port's two paths differ by no
    more than the JAX model's, plus the bf16 tolerance; run with ``-s``
    to read both gaps."""
    jcfg, tcfg = _configs(compute_dtype="bfloat16", d_model=width,
                          lru_width=width, d_ff=3 * width)
    params = _weights(jcfg)
    B, S = 2, 40
    batch = _tokens(jcfg, B, S, seed=2)
    jmodel, tmodel = j_build_model(jcfg), t_build_model(tcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jpre = np.asarray(j_make_prefill_step(jmodel, JSharder(None))(jparams, jbatch),
                      np.float32)
    jstep = jax.jit(j_make_serve_step(jmodel, JSharder(None)))
    jcache = j_init_tree(jax.random.PRNGKey(1), jmodel.cache_specs(B, S),
                         jcfg.param_dtype)
    tparams = tmodel.compute_params(params_from_numpy(params, device="cpu"))
    tpre = make_prefill_step(tmodel, TSharder(None))(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}).float().numpy()
    tstep = make_serve_step(tmodel, TSharder(None))
    tcache, _, _ = make_decode_inputs(tcfg, B, S, torch.Generator(), "cpu")
    jgap = tgap = 0.0
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        jlog, jcache = jstep(jparams, jcache, jbatch["tokens"][:, t], jnp.asarray(pos))
        tlog, tcache = tstep(tparams, tcache, torch.from_numpy(batch["tokens"][:, t]),
                             torch.from_numpy(pos))
        jgap = max(jgap, np.abs(np.asarray(jlog, np.float32) - jpre[:, t]).max())
        tgap = max(tgap, np.abs(tlog.float().numpy() - tpre[:, t]).max())
    scale = np.abs(jpre).max()
    print(f"d_model {width}: bf16 forward vs teacher-forced decode, JAX "
          f"{jgap:.4g} ({jgap / scale * 100:.2f}% of the largest logit), port "
          f"{tgap:.4g} ({tgap / scale * 100:.2f}%)")
    assert tgap <= jgap + 2e-2 * scale


def test_compute_params_keeps_lam_and_the_norms_fp32():
    """Cast to bf16, lam would round what the JAX model reads in fp32
    (rglru.py:79, 144)."""
    _, cfg = _configs(compute_dtype="bfloat16")
    model = t_build_model(cfg)
    params = init_tree(torch.Generator().manual_seed(0), model.param_specs(),
                       device="cpu")
    cp = model.compute_params(params)
    for block in (cp["superblocks"]["rec1"], cp["superblocks"]["rec2"],
                  *cp["tail"].values()):
        assert block["rec"]["lam"].dtype == torch.float32
        assert block["ln1"].dtype == block["ln2"].dtype == torch.float32
        for key in ("w_in", "w_gate_branch", "conv_w", "wa", "wx", "w_out"):
            assert block["rec"][key].dtype == torch.bfloat16, key
    torch.testing.assert_close(cp["tail"]["0"]["rec"]["lam"],
                               params["tail"]["0"]["rec"]["lam"], rtol=0, atol=0)
    assert cp["superblocks"]["attn"]["ln1"].dtype == torch.float32
    assert cp["superblocks"]["attn"]["attn"]["wq"].dtype == torch.bfloat16
    assert cp["final_norm"].dtype == torch.float32
