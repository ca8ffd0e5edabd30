"""Port parity for the SSM family: mamba2_block and mamba2_decode (outputs
and cache), LM.forward and LM.decode_step of mamba2-2.7b smoke against the
JAX package on the same numpy weights and inputs, and the forward against
teacher-forced decode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke as j_get_smoke
from repro.models import mamba2 as jm2
from repro.models.base import init_tree as j_init_tree
from repro.models.registry import build_model as j_build_model
from repro.runtime.sharding import Sharder as JSharder
from repro.train.step import make_serve_step as j_make_serve_step
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.launch.inputs import make_decode_inputs
from repro_torch.models import mamba2 as tm2
from repro_torch.models.base import (init_tree, params_from_numpy, tree_leaves,
                                     tree_map)
from repro_torch.models.registry import build_model as t_build_model
from repro_torch.runtime.sharding import Sharder as TSharder
from repro_torch.train.step import make_prefill_step, make_serve_step

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

ARCH = "mamba2_2_7b"
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


def _draw(specs, seed=0):
    """Weights for both packages: the port's init of ``specs`` (the JAX
    specs' shapes and scales) as numpy arrays. The JAX init would compile
    a program for every leaf, seconds a tree."""
    return tree_map(lambda t: t.numpy(), init_tree(
        torch.Generator().manual_seed(seed), specs, device="cpu"))


def _mixer_params(jcfg, seed=0):
    """The mixer's init with A_log, dt_bias, D, conv_b and the norm scale
    drawn away from their constant inits, so each is exercised."""
    params = _draw(tm2.mamba2_specs(jcfg), seed)
    rng = np.random.default_rng(seed)
    for key, scale in (("A_log", 0.5), ("dt_bias", 0.5), ("D", 0.5),
                       ("conv_b", 0.1), ("norm", 0.2)):
        params[key] = (params[key] + rng.normal(scale=scale, size=params[key].shape)
                       ).astype(np.float32)
    return params


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_block_matches_jax(dtype):
    jcfg, tcfg = _configs()
    jdt, tdt, tol = DTYPES[dtype]
    params = _mixer_params(jcfg)
    B, S = 2, 48  # three chunks of 16
    x = np.random.default_rng(1).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    want, wh = jm2.mamba2_block(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                                JSharder(None), jnp.asarray(x).astype(jdt),
                                return_state=True)
    got, gh = tm2.mamba2_block(params_from_numpy(params, device="cpu"), tcfg,
                               TSharder(None), torch.from_numpy(x).to(tdt),
                               return_state=True)
    assert got.dtype == tdt and gh.dtype == torch.float32
    _close(got, want, tol)
    _close(gh, wh, tol)


def test_mamba2_decode_matches_jax():
    jcfg, tcfg = _configs()
    params = _mixer_params(jcfg)
    B = 2
    rng = np.random.default_rng(2)
    jcache = j_init_tree(jax.random.PRNGKey(1), jm2.mamba2_cache_specs(jcfg, B))
    tcache = params_from_numpy(_np_tree(jcache), device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = params_from_numpy(params, device="cpu")
    for _ in range(6):  # past the conv buffer's 3 steps
        x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        jy, jcache = jm2.mamba2_decode(jparams, jcfg, JSharder(None),
                                       jnp.asarray(x), jcache)
        ty, same = tm2.mamba2_decode(tparams, tcfg, TSharder(None),
                                     torch.from_numpy(x), tcache)
        assert same is tcache  # updated in place
        _close(ty, jy, 2e-5)
    for key in ("h", "conv"):
        _close(tcache[key], jcache[key], 2e-5)


def test_block_state_equals_the_decode_state():
    """The full-sequence block's final state is the state the decode steps
    reach over the same inputs."""
    _, cfg = _configs()
    params = params_from_numpy(_mixer_params(j_get_smoke(ARCH)), device="cpu")
    B, S = 2, 32
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, S, cfg.d_model)).astype(np.float32))
    y, h = tm2.mamba2_block(params, cfg, TSharder(None), x, return_state=True)
    cache = init_tree(torch.Generator(), tm2.mamba2_cache_specs(cfg, B), device="cpu")
    for t in range(S):
        yt, cache = tm2.mamba2_decode(params, cfg, TSharder(None), x[:, t:t + 1], cache)
        torch.testing.assert_close(yt[:, 0], y[:, t], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cache["h"], h, rtol=1e-4, atol=1e-4)


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32),
            "positions": np.ascontiguousarray(
                np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)))}


def _weights(jcfg, seed=0):
    return _draw(t_build_model(jcfg).param_specs(), seed)


def test_param_specs_and_cache_specs_match_jax():
    jcfg, tcfg = _configs()
    jm, tm = j_build_model(jcfg), t_build_model(tcfg)
    for jspecs, tspecs in ((jm.param_specs(), tm.param_specs()),
                           (jm.cache_specs(2, 8), tm.cache_specs(2, 8))):
        jflat = jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda s: hasattr(s, "axes"))[0]
        assert [(s.shape, s.axes, s.init, s.dtype) for _, s in jflat] == [
            (s.shape, s.axes, s.init, s.dtype) for s in tree_leaves(tspecs)]


def _forward_logits(dtype, params, batch):
    """(JAX logits, port logits) of the smoke model in ``dtype``."""
    jcfg, tcfg = _configs(compute_dtype=dtype)
    jmodel, tmodel = j_build_model(jcfg), t_build_model(tcfg)
    jlogits, _ = jax.jit(lambda p, b: jmodel.forward(p, b, JSharder(None)))(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        tlogits, aux = tmodel.forward(
            tmodel.compute_params(params_from_numpy(params, device="cpu")),
            {k: torch.from_numpy(v) for k, v in batch.items()}, TSharder(None))
    assert all(float(a) == 0.0 for a in aux.values())
    return np.asarray(jlogits, np.float32), tlogits.float().numpy()


def test_forward_logits_match_jax():
    params = _weights(j_get_smoke(ARCH))
    want, got = _forward_logits("float32", params, _tokens(j_get_smoke(ARCH), 2, 32, 1))
    _close(torch.from_numpy(got), want, 2e-5)


def test_bf16_forward_is_as_close_to_fp32_as_jax():
    """In bf16 the two frameworks round in other places (XLA keeps fused
    elementwise chains in fp32), and after two layers each is ~0.2 from
    the fp32 logits while they are ~0.09 apart, above 2e-2 of the scale
    (4.1). So the port's bf16 logits are held to the fp32 logits within
    JAX's own bf16 distance from them plus 2e-2 of the scale."""
    params = _weights(j_get_smoke(ARCH))
    batch = _tokens(j_get_smoke(ARCH), 2, 32, 1)
    exact, _ = _forward_logits("float32", params, batch)
    want, got = _forward_logits("bfloat16", params, batch)
    jax_err = np.abs(want - exact).max()
    assert np.abs(got - exact).max() <= jax_err + 2e-2 * np.abs(exact).max()


def test_greedy_decode_matches_jax():
    jcfg, tcfg = _configs()
    B, steps = 2, 8
    jmodel, tmodel = j_build_model(jcfg), t_build_model(tcfg)
    params = _weights(jcfg)
    jstep = jax.jit(j_make_serve_step(jmodel, JSharder(None)))
    tstep = make_serve_step(tmodel, TSharder(None))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = tmodel.compute_params(params_from_numpy(params, device="cpu"))
    jcache = j_init_tree(jax.random.PRNGKey(1), jmodel.cache_specs(B, 16),
                         jcfg.param_dtype)
    tcache, _, _ = make_decode_inputs(tcfg, B, 16, torch.Generator(), "cpu")
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
    for key in ("h", "conv"):
        _close(tcache["layers"][key], jcache["layers"][key], 2e-5)


def test_prefill_agrees_with_teacher_forced_decode():
    """Logits of one forward at every position t equal the decode step's
    after feeding tokens 0..t (tests/test_smoke_archs.py:85-120)."""
    _, cfg = _configs()
    model = t_build_model(cfg)
    params = model.compute_params(params_from_numpy(_weights(j_get_smoke(ARCH)),
                                                    device="cpu"))
    B, S = 2, 32  # two chunks of 16
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


def test_compute_params_keeps_the_fp32_leaves():
    """Cast to bf16, A_log, dt_bias, D and the gated norm's scale would
    round what the JAX model reads in fp32 (mamba2.py:129-140, 196)."""
    _, cfg = _configs(compute_dtype="bfloat16")
    model = t_build_model(cfg)
    params = init_tree(torch.Generator().manual_seed(0), model.param_specs(),
                       device="cpu")
    mixer = params["layers"]["mixer"]
    for key in ("A_log", "dt_bias", "D", "norm"):
        mixer[key] = torch.randn(mixer[key].shape, generator=torch.Generator()
                                 .manual_seed(1))
    cp = model.compute_params(params)["layers"]
    for key in ("A_log", "dt_bias", "D", "norm"):
        assert cp["mixer"][key].dtype == torch.float32, key
        torch.testing.assert_close(cp["mixer"][key], mixer[key], rtol=0, atol=0)
    assert cp["ln"].dtype == torch.float32
    for key in ("wz", "wx", "wB", "wC", "wdt", "conv_w", "conv_b", "wo"):
        assert cp["mixer"][key].dtype == torch.bfloat16, key


def test_published_dt_A_draws_mamba2s_ranges_and_decode_agrees():
    """A in [1, 16] and softplus(dt_bias) in [1e-3, 1e-1], every other leaf
    the same object; on those weights the forward over three chunks agrees
    with teacher-forced decode (the card's forward-vs-decode check)."""
    _, cfg = _configs()
    model = t_build_model(cfg)
    params = model.compute_params(params_from_numpy(_weights(j_get_smoke(ARCH)),
                                                    device="cpu"))
    cond = tm2.published_dt_A(params, torch.Generator().manual_seed(5))
    A = cond["layers"]["mixer"]["A_log"].exp()
    dt = torch.nn.functional.softplus(cond["layers"]["mixer"]["dt_bias"])
    assert A.dtype == dt.dtype == torch.float32
    assert bool(((A >= 1) & (A <= 16)).all())
    assert bool(((dt >= 1e-3 * (1 - 1e-5)) & (dt <= 1e-1 * (1 + 1e-5))).all())
    for key, leaf in params["layers"]["mixer"].items():
        if key not in ("A_log", "dt_bias"):
            assert cond["layers"]["mixer"][key] is leaf, key
    assert cond["embed"] is params["embed"]
    B, S = 2, 3 * cfg.ssm_chunk
    batch = {k: torch.from_numpy(v) for k, v in _tokens(cfg, B, S, seed=3).items()}
    prefill = make_prefill_step(model, TSharder(None))(cond, batch)
    step = make_serve_step(model, TSharder(None))
    cache, _, _ = make_decode_inputs(cfg, B, S, torch.Generator(), "cpu")
    for t in range(S):
        logits, cache = step(cond, cache, batch["tokens"][:, t],
                             torch.full((B,), t, dtype=torch.int32))
        want = prefill[:, t]
        torch.testing.assert_close(
            logits, want, rtol=2e-5, atol=2e-5 * max(1.0, want.abs().max().item()))
