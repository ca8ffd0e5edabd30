"""Port parity for the MoE family: moe_block (scatter and one-hot
dispatch, with and without capacity drops, and the aux and z losses),
LM.forward and LM.decode_step of deepseek-moe-16b smoke against the JAX
package on the same numpy weights and inputs, and the forward against
teacher-forced decode. The served deepseek smoke is held token for token
to the JAX engine in tests/test_torch_engine.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke as j_get_smoke
from repro.models import moe as jmoe
from repro.models.base import init_tree as j_init_tree
from repro.models.registry import build_model as j_build_model
from repro.runtime.sharding import Sharder as JSharder
from repro.train.step import make_serve_step as j_make_serve_step
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.launch.inputs import make_decode_inputs
from repro_torch.models import moe as tmoe
from repro_torch.models.base import (init_tree, params_from_numpy, tree_leaves,
                                     tree_map)
from repro_torch.models.registry import build_model as t_build_model
from repro_torch.runtime.sharding import Sharder as TSharder
from repro_torch.train.step import make_prefill_step, make_serve_step

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

ARCH = "deepseek_moe_16b"
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


# --------------------------------------------------------------------------- #
# moe_block
# --------------------------------------------------------------------------- #
#: capacity factors: the smoke config's 1.25 (C = 6 of 32 slots a row),
#: 0.25 (C = 4: a third of the routed tokens are dropped) and 8 (dropless)
CAPACITY = {"cf 1.25": 1.25, "cf 0.25 drops": 0.25, "cf 8 dropless": 8.0}


def _draw(specs, seed=0):
    """Weights for both packages: the port's init of ``specs`` (the JAX
    specs' shapes and scales) as numpy arrays. The JAX init would compile
    a program for every leaf, seconds a tree."""
    return tree_map(lambda t: t.numpy(), init_tree(
        torch.Generator().manual_seed(seed), specs, device="cpu"))


def _moe_params():
    return _draw(tmoe.moe_specs(t_get_smoke(ARCH)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ["scatter", "onehot"])
@pytest.mark.parametrize("cap", CAPACITY)
def test_moe_block_matches_jax(cap, impl, dtype):
    jcfg, tcfg = _configs(capacity_factor=CAPACITY[cap])
    jdt, tdt, tol = DTYPES[dtype]
    params = _moe_params()
    B, S = 2, 16
    x = np.random.default_rng(3).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_block(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                              JSharder(None), jnp.asarray(x).astype(jdt), impl=impl)
    ty, taux = tmoe.moe_block(params_from_numpy(params, device="cpu"), tcfg,
                              TSharder(None), torch.from_numpy(x).to(tdt), impl=impl)
    assert ty.dtype == tdt and ty.shape == (B, S, jcfg.d_model)
    _close(ty, jy, tol)
    for key in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-5)
    if cap == "cf 0.25 drops":  # the case really drops
        logits = torch.from_numpy(x) @ torch.tensor(params["router"])
        _, eidx = tmoe.top_k_gates(torch.softmax(logits, -1), jcfg.top_k)
        _, keep = tmoe.expert_positions(eidx, jcfg.n_experts, 4)
        assert 0 < int((~keep).sum()) < keep.numel()


def test_expert_positions_count_choices_in_order():
    # row 0: tokens pick experts (0, 1), (0, 2), (1, 0): expert 0 fills slots
    # 0, 1 from choice 0, then slot 2 from token 2's choice 1
    eidx = torch.tensor([[[0, 1], [0, 2], [1, 0]]])
    pos, keep = tmoe.expert_positions(eidx, 3, 2)
    assert pos.tolist() == [[[0, 1], [1, 0], [0, 2]]]
    assert keep.tolist() == [[[True, True], [True, True], [True, False]]]


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
def _weights(jcfg, seed=0):
    """``_draw`` of the smoke model, wq, wk and wv rescaled to std
    1/sqrt(d_model) in every attention stack (see test_torch_prefill's
    ``_weights``: the init's fan-in makes the attention near-hard)."""
    params = _draw(t_build_model(t_get_smoke(ARCH)).param_specs(), seed)
    for stack in ("layers", "dense_layers"):
        attn = params[stack]["attn"]
        for key, n in (("wq", jcfg.n_heads), ("wk", jcfg.n_kv_heads),
                       ("wv", jcfg.n_kv_heads)):
            attn[key] = attn[key] * np.float32(np.sqrt(n / jcfg.d_model))
    return params


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32),
            "positions": np.ascontiguousarray(
                np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)))}


def test_param_specs_and_cache_specs_match_jax():
    jcfg, tcfg = _configs()
    jm, tm = j_build_model(jcfg), t_build_model(tcfg)
    for jspecs, tspecs in ((jm.param_specs(), tm.param_specs()),
                           (jm.cache_specs(2, 8), tm.cache_specs(2, 8))):
        jflat = jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda s: hasattr(s, "axes"))[0]
        assert [(s.shape, s.axes, s.init, s.dtype) for _, s in jflat] == [
            (s.shape, s.axes, s.init, s.dtype) for s in tree_leaves(tspecs)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_logits_and_aux_match_jax(dtype):
    jcfg, tcfg = _configs(compute_dtype=dtype)
    params = _weights(jcfg)
    batch = _tokens(jcfg, 2, 24, seed=1)
    jmodel, tmodel = j_build_model(jcfg), t_build_model(tcfg)
    jlogits, jaux = jmodel.forward(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, JSharder(None))
    with torch.inference_mode():
        tlogits, taux = tmodel.forward(
            tmodel.compute_params(params_from_numpy(params, device="cpu")),
            {k: torch.from_numpy(v) for k, v in batch.items()}, TSharder(None))
    _close(tlogits, jlogits, DTYPES[dtype][2])
    for key in ("moe_aux", "moe_z"):
        assert float(taux[key]) > 0
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-4 if dtype == "float32" else 2e-2)


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
    for stack in ("layers", "dense_layers"):
        for key in ("k", "v", "pos"):
            np.testing.assert_allclose(tcache[stack][key].numpy(),
                                       np.asarray(jcache[stack][key]),
                                       rtol=1e-4, atol=1e-4)


def test_prefill_agrees_with_teacher_forced_decode():
    """Logits of one forward at every position t equal the decode step's
    after feeding tokens 0..t, under ample capacity: the forward drops
    over-capacity tokens per row while decode routes the batch as one
    group, so the two agree only where nothing is dropped (as in
    tests/test_smoke_archs.py:85-120)."""
    _, cfg = _configs(capacity_factor=8.0)
    model = t_build_model(cfg)
    params = model.compute_params(params_from_numpy(_weights(j_get_smoke(ARCH)),
                                                    device="cpu"))
    B, S = 2, 16
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


def test_compute_params_keeps_the_router_in_fp32():
    _, cfg = _configs(compute_dtype="bfloat16")
    model = t_build_model(cfg)
    params = init_tree(torch.Generator().manual_seed(0), model.param_specs(),
                       device="cpu")
    cp = model.compute_params(params)
    assert cp["layers"]["moe"]["router"].dtype == torch.float32
    torch.testing.assert_close(cp["layers"]["moe"]["router"],
                               params["layers"]["moe"]["router"], rtol=0, atol=0)
    for key in ("wg", "wu", "wd"):
        assert cp["layers"]["moe"][key].dtype == torch.bfloat16
    assert cp["layers"]["moe"]["shared"]["gate"].dtype == torch.bfloat16
    assert cp["dense_layers"]["mlp"]["gate"].dtype == torch.bfloat16


def test_prefill_step_passes_the_forward_through():
    _, cfg = _configs()
    model = t_build_model(cfg)
    params = init_tree(torch.Generator().manual_seed(0), model.param_specs(),
                       device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _tokens(cfg, 2, 8, seed=0).items()}
    with torch.inference_mode():
        logits, aux = model.forward(params, batch, TSharder(None))
    torch.testing.assert_close(
        make_prefill_step(model, TSharder(None))(params, batch), logits)
    assert sorted(aux) == ["moe_aux", "moe_z"]


# --------------------------------------------------------------------------- #
# the static dispatch (a trash row, no boolean mask)
# --------------------------------------------------------------------------- #
def _mask_dispatch(x, eidx, pos_k, keep_k, E, C):
    """The boolean-mask dispatch the port had before the trash row: the kept
    (token, choice) pairs picked out by ``[keep_k]`` (a data-dependent
    ``nonzero``, a host sync on the card) and copied to their slots."""
    B, S, d = x.shape
    K = eidx.shape[-1]
    rows = torch.arange(B)[:, None, None]
    slot = ((eidx * B + rows) * C + pos_k)[keep_k]
    src = x[:, :, None, :].expand(B, S, K, d)[keep_k]
    x_e = torch.zeros((E * B * C, d), dtype=x.dtype)
    x_e.index_copy_(0, slot, src)
    return x_e


def _routed(cap, dtype, seed=3):
    """moe_block's inputs at the capacity factor ``cap`` (the smoke config's
    8 experts, top-2), with the routing of its x."""
    _, cfg = _configs(capacity_factor=CAPACITY[cap])
    params = params_from_numpy(_moe_params(), device="cpu")
    B, S = 2, 16
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)).to(DTYPES[dtype][1])
    x[0, 0, :4] = -0.0  # signed zeros are copied, not added
    C = tmoe._capacity(S, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    probs = torch.softmax(x.float() @ params["router"], -1)
    _, eidx = tmoe.top_k_gates(probs, cfg.top_k)
    pos, keep = tmoe.expert_positions(eidx, cfg.n_experts, C)
    return cfg, params, x, eidx, pos, keep, C


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cap", CAPACITY)
def test_static_dispatch_equals_the_mask_dispatch_bit_for_bit(cap, dtype):
    """The buffer, and moe_block's output and aux losses, equal the mask
    dispatch's bit for bit, where choices are dropped (cf 0.25) too."""
    cfg, params, x, eidx, pos, keep, C = _routed(cap, dtype)
    E = cfg.n_experts
    if cap == "cf 0.25 drops":
        assert 0 < int((~keep).sum()) < keep.numel()
    got = tmoe._dispatch(x, eidx, pos, keep, E, C)
    want = _mask_dispatch(x, eidx, pos, keep, E, C)
    assert got.shape == want.shape and got.dtype == x.dtype
    assert torch.equal(got.view(torch.int16 if dtype == "bfloat16" else torch.int32),
                       want.view(torch.int16 if dtype == "bfloat16" else torch.int32))
    y, aux = tmoe.moe_block(params, cfg, TSharder(None), x)
    orig = tmoe._dispatch
    try:
        tmoe._dispatch = _mask_dispatch
        y_mask, aux_mask = tmoe.moe_block(params, cfg, TSharder(None), x)
    finally:
        tmoe._dispatch = orig
    assert torch.equal(y, y_mask)
    for key in aux:
        assert torch.equal(aux[key], aux_mask[key])


class _OpLog(torch.utils._python_dispatch.TorchDispatchMode):
    """The aten ops a call runs, by name."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func._overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_moe_block_traces_under_fake_tensors_without_nonzero():
    """Under ``FakeTensorMode`` (no data, so no shape that depends on it)
    moe_block traces and runs no ``nonzero``; the mask dispatch cannot."""
    from torch._subclasses.fake_tensor import (DynamicOutputShapeException,
                                               FakeTensorMode)

    cfg, params, x, eidx, pos, keep, C = _routed("cf 0.25 drops", "bfloat16")
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        fparams = tree_map(mode.from_tensor, params)
        fx = mode.from_tensor(x)
        log = _OpLog()
        with log:
            y, aux = tmoe.moe_block(fparams, cfg, TSharder(None), fx)
        assert y.shape == x.shape and y.dtype == x.dtype
        assert "index_copy_" in log.names and "nonzero" not in log.names
        with pytest.raises(DynamicOutputShapeException):
            _mask_dispatch(fx, *(mode.from_tensor(t) for t in (eidx, pos, keep)),
                           cfg.n_experts, C)
