"""Port parity for the VLM family (qwen2-vl): M-RoPE (apply_rope with
``mrope_sections``), attention_decode with [3,B] position streams,
LM.forward on patch embeddings and LM.decode_step on [B,1,Din] embeddings
against the JAX package on the same numpy inputs and weights (fp32 2e-5,
bf16 2e-2, the tolerances of tests/test_kernels.py); the port's
teacher-forced decode against its own forward; and the layout of
make_batch and make_decode_inputs.

The position streams are distinct: with three equal streams M-RoPE is
plain RoPE, and a section given the wrong stream would not show."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.launch.inputs import make_batch, make_decode_inputs
from repro_torch.models import attention as tattn
from repro_torch.models import layers as TL
from repro_torch.models.base import params_from_numpy
from repro_torch.models.registry import build_model as t_build_model
from repro_torch.runtime.sharding import Sharder as TSharder
from repro_torch.train.step import make_prefill_step, make_serve_step

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

ARCH = "qwen2_vl_7b"
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _jax():
    """The JAX package's modules this file compares against."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_smoke
    from repro.launch import inputs
    from repro.models import attention, layers
    from repro.models.base import init_tree
    from repro.models.registry import build_model
    from repro.runtime.sharding import Sharder
    from repro.train.step import make_prefill_step as prefill
    from repro.train.step import make_serve_step as serve

    return dict(jax=jax, jnp=jnp, get_smoke=get_smoke, inputs=inputs,
                attention=attention, layers=layers, init_tree=init_tree,
                build_model=build_model, Sharder=Sharder, prefill=prefill,
                serve=serve)


def _close(got, want, tol):
    """Within ``tol`` of the output's scale: the projections sum terms of
    that size in another order in each framework."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _distinct(streams):
    """Asserts that no two of the three position streams are equal."""
    for i, j in ((0, 1), (0, 2), (1, 2)):
        assert not np.array_equal(streams[i], streams[j]), (i, j)
    return streams


def _vlm_streams(B, S):
    """[3,B,S] streams: the temporal stream ``arange`` in every row (the
    decode cache keys its ring on it), and h and w streams that differ
    from it and from each other, offset by the row (b) and 2b."""
    s = np.arange(S, dtype=np.int32)
    rows = np.stack([s, s // 4, s % 4 + 7])                        # [3,S]
    streams = rows[:, None, :] + np.arange(B, dtype=np.int32)[None, :, None] \
        * np.array([0, 1, 2], np.int32)[:, None, None]
    return _distinct(np.ascontiguousarray(streams.astype(np.int32)))


def _weights(J, jcfg, seed=0):
    """The JAX init as numpy arrays, qkv biases randomised and wq, wk, wv
    at std 1/sqrt(d_model) (tests/test_torch_prefill.py's ``_weights``)."""
    params = J["jax"].tree_util.tree_map(np.asarray, J["init_tree"](
        J["jax"].random.PRNGKey(seed), J["build_model"](jcfg).param_specs(),
        jcfg.param_dtype))
    rng = np.random.default_rng(seed)
    attn = params["layers"]["attn"]
    for k in ("bq", "bk", "bv"):
        attn[k] = rng.normal(scale=0.5, size=attn[k].shape).astype(np.float32)
    for key, n in (("wq", jcfg.n_heads), ("wk", jcfg.n_kv_heads),
                   ("wv", jcfg.n_kv_heads)):
        attn[key] = attn[key] * np.float32(np.sqrt(n / jcfg.d_model))
    return params


def _configs(J, **kw):
    return (dataclasses.replace(J["get_smoke"](ARCH), **kw),
            dataclasses.replace(t_get_smoke(ARCH), **kw))


# --------------------------------------------------------------------------- #
# (a) M-RoPE
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
def test_mrope_matches_jax(sections, dtype):
    J = _jax()
    jnp = J["jnp"]
    D = 2 * sum(sections)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, D)).astype(np.float32)
    pos = _distinct(rng.integers(0, 4000, size=(3, 2, 7)).astype(np.int32))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = J["layers"].apply_rope(jnp.asarray(x).astype(jdt), jnp.asarray(pos),
                                  1e6, sections)
    got = TL.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(pos), 1e6, sections)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    _close(got, want, TOL[dtype])


def test_mrope_sections_reach_their_streams():
    """Band j turns with stream i exactly where section i holds j; without
    sections the [3,B,S] input rotates by its first stream."""
    sections = (2, 3, 3)
    D, theta = 2 * sum(sections), 1e4
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(1, 5, 2, D)).astype(np.float32))
    pos = torch.from_numpy(_distinct(rng.integers(0, 500, size=(3, 1, 5))))
    got = TL.apply_rope(x, pos, theta, sections)
    owner = np.repeat([0, 1, 2], sections)                         # [D/2]
    for i in range(3):
        want = TL.apply_rope(x, pos[i], theta)
        band = np.concatenate([owner == i, owner == i])
        torch.testing.assert_close(got[..., band], want[..., band])
    torch.testing.assert_close(TL.apply_rope(x, pos, theta),
                               TL.apply_rope(x, pos[0], theta))


# --------------------------------------------------------------------------- #
# (b) attention_decode with [3,B] positions
# --------------------------------------------------------------------------- #
def test_attention_decode_with_mrope_streams_matches_jax():
    J = _jax()
    jax, jnp = J["jax"], J["jnp"]
    jcfg, tcfg = J["get_smoke"](ARCH), t_get_smoke(ARCH)
    rng = np.random.default_rng(11)
    B, max_len, steps = 2, 8, 11  # steps > W: the ring wraps
    params = jax.tree_util.tree_map(np.asarray, J["init_tree"](
        jax.random.PRNGKey(0), J["attention"].attn_specs(jcfg)))
    for k in ("bq", "bk", "bv"):
        params[k] = rng.normal(scale=0.5, size=params[k].shape).astype(np.float32)
    jcache = J["init_tree"](jax.random.PRNGKey(1), J["attention"].cache_specs(
        jcfg, B, max_len, window=None))
    tcache = params_from_numpy(jax.tree_util.tree_map(np.asarray, jcache),
                               device="cpu")
    tparams = params_from_numpy(params, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    # stream 0 strictly increasing; streams 1 and 2 distinct from it and
    # from each other
    streams = _vlm_streams(B, steps)
    for t in range(steps):
        x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        pos = np.ascontiguousarray(streams[:, :, t])
        jy, jcache = J["attention"].attention_decode(
            jparams, jcfg, J["Sharder"](None), jnp.asarray(x), jcache,
            jnp.asarray(pos))
        ty, tcache = tattn.attention_decode(
            tparams, tcfg, TSharder(None), torch.from_numpy(x), tcache,
            torch.from_numpy(pos))
        _close(ty, jy, TOL["float32"])
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                   rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------- #
# (c) the forward, (d) the decode step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("backend", ["chunked", "pallas"])
def test_forward_on_patches_matches_jax(backend, dtype):
    J = _jax()
    jax, jnp = J["jax"], J["jnp"]
    jcfg, tcfg = _configs(J, attn_backend=backend, compute_dtype=dtype)
    params = _weights(J, jcfg)
    B, S = 2, 40
    rng = np.random.default_rng(3)
    batch = {"embeds": rng.normal(size=(B, S, jcfg.frontend_dim)).astype(np.float32),
             "positions": _vlm_streams(B, S)}
    want = J["prefill"](J["build_model"](jcfg), J["Sharder"](None))(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tmodel = t_build_model(tcfg)
    got = make_prefill_step(tmodel, TSharder(None))(
        tmodel.compute_params(params_from_numpy(params, device="cpu")),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (B, S, jcfg.vocab)
    _close(got, want, TOL[dtype])
    if dtype == "float32":
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))


@pytest.mark.parametrize("dtype", TOL)
def test_decode_step_on_patches_matches_jax(dtype):
    J = _jax()
    jax, jnp = J["jax"], J["jnp"]
    jcfg, tcfg = _configs(J, compute_dtype=dtype)
    params = _weights(J, jcfg)
    B, max_len, steps = 2, 16, 8
    rng = np.random.default_rng(5)
    jmodel, tmodel = J["build_model"](jcfg), t_build_model(tcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = tmodel.compute_params(params_from_numpy(params, device="cpu"))
    jstep = jax.jit(J["serve"](jmodel, J["Sharder"](None)))
    tstep = make_serve_step(tmodel, TSharder(None))
    jcache = J["init_tree"](jax.random.PRNGKey(1), jmodel.cache_specs(B, max_len),
                            jcfg.param_dtype)
    tcache, _, _ = make_decode_inputs(tcfg, B, max_len, torch.Generator(), "cpu")
    streams = _vlm_streams(B, steps)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    for t in range(steps):
        x = rng.normal(size=(B, 1, jcfg.frontend_dim)).astype(np.float32)
        pos = np.ascontiguousarray(streams[:, :, t])
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(x).astype(jdt),
                             jnp.asarray(pos))
        tlog, tcache = tstep(tparams, tcache,
                             torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(pos))
        assert tlog.shape == (B, jcfg.vocab)
        _close(tlog, jlog, TOL[dtype])
    for key in ("k", "v", "pos"):
        _close(tcache["layers"][key], jcache["layers"][key], TOL[dtype])


# --------------------------------------------------------------------------- #
# (e) the port's teacher-forced decode against its own forward
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["chunked", "pallas"])
def test_teacher_forced_decode_equals_forward(backend):
    """Logits of one forward at every position t equal the decode step's
    after feeding embeddings 0..t with the same streams, at the tolerance
    of the JAX package's tests/test_smoke_archs.py::test_decode_matches_prefill
    (which leaves the VLM out)."""
    cfg = dataclasses.replace(t_get_smoke(ARCH), attn_backend=backend)
    model = t_build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.base import init_tree

    params = model.compute_params(init_tree(gen, model.param_specs(),
                                            cfg.param_dtype, "cpu"))
    for k in ("bq", "bk", "bv"):
        params["layers"]["attn"][k] = 0.5 * torch.randn(
            params["layers"]["attn"][k].shape, generator=gen)
    B, S = 2, 24
    batch = make_batch(cfg, B, S, gen, "cpu", with_labels=False)
    batch["positions"] = torch.from_numpy(_vlm_streams(B, S))
    prefill = make_prefill_step(model, TSharder(None))(params, batch)
    step = make_serve_step(model, TSharder(None))
    cache, _, _ = make_decode_inputs(cfg, B, S, torch.Generator(), "cpu")
    for t in range(S):
        logits, cache = step(params, cache, batch["embeds"][:, t:t + 1],
                             batch["positions"][:, :, t])
        torch.testing.assert_close(logits, prefill[:, t], rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------------------- #
# (f) the inputs' layout
# --------------------------------------------------------------------------- #
def test_make_batch_and_decode_inputs_match_jax_layout():
    J = _jax()
    jax = J["jax"]
    jcfg, tcfg = J["get_smoke"](ARCH), t_get_smoke(ARCH)
    B, S = 3, 10
    jb = J["inputs"].make_batch(jcfg, B, S, jax.random.PRNGKey(0))
    tb = make_batch(tcfg, B, S, torch.Generator().manual_seed(0), "cpu")
    assert sorted(tb) == sorted(jb) == ["embeds", "labels", "positions"]
    for key in tb:
        assert tuple(tb[key].shape) == jb[key].shape, key
        assert str(tb[key].dtype).split(".")[-1] == str(jb[key].dtype), key
    np.testing.assert_array_equal(tb["positions"].numpy(), np.asarray(jb["positions"]))
    assert tuple(tb["positions"].shape) == (3, B, S)

    jc, jtok, jpos = J["inputs"].make_decode_inputs(jcfg, B, 12,
                                                    jax.random.PRNGKey(0), pos=5)
    tc, ttok, tpos = make_decode_inputs(tcfg, B, 12, torch.Generator(), "cpu",
                                        pos=5)
    assert tuple(ttok.shape) == jtok.shape == (B, 1, tcfg.frontend_dim)
    assert ttok.dtype == getattr(torch, tcfg.compute_dtype)
    assert str(jtok.dtype) == tcfg.compute_dtype
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert tuple(tpos.shape) == (3, B) and tpos.dtype == torch.int32
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(tc["layers"][key].numpy(),
                                      np.asarray(jc["layers"][key]))


def test_reset_slot_and_conditioned_act_on_the_vlm_stack():
    """Both act on the "layers" stack, which the VLM shares with the dense
    family: a slot's row goes back to the fresh cache's values, and wq,
    wk, wv are rescaled to std 1/sqrt(d_model) while the rest is kept."""
    from repro_torch.launch.inputs import conditioned
    from repro_torch.models.base import init_tree

    cfg = t_get_smoke(ARCH)
    model = t_build_model(cfg)
    fresh, _, _ = make_decode_inputs(cfg, 2, 8, torch.Generator(), "cpu")
    cache, _, _ = make_decode_inputs(cfg, 2, 8, torch.Generator(), "cpu")
    for leaf in cache["layers"].values():
        leaf.fill_(3)
    model.reset_slot(cache, 1)
    for key, leaf in cache["layers"].items():
        torch.testing.assert_close(leaf[:, 1], fresh["layers"][key][:, 1])
        assert bool((leaf[:, 0] == 3).all()), key

    params = init_tree(torch.Generator().manual_seed(0), model.param_specs(),
                       device="cpu")
    cond = conditioned(cfg, params)
    for key, n in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                   ("wv", cfg.n_kv_heads)):
        torch.testing.assert_close(
            cond["layers"]["attn"][key],
            params["layers"]["attn"][key] * np.sqrt(n / cfg.d_model))
    assert cond["layers"]["attn"]["wo"] is params["layers"]["attn"]["wo"]
    assert cond["frontend"] is params["frontend"]
