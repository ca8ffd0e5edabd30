"""Port parity for the model: attention_decode (outputs and cache contents)
and LM.decode_step against the JAX package, with the JAX weights carried
into the port by params_from_numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch, get_smoke
from repro.models import attention as jattn
from repro.models.base import init_tree as j_init_tree
from repro.models.registry import build_model as j_build_model
from repro.runtime.sharding import Sharder as JSharder
from repro.train.step import make_serve_step as j_make_serve_step
from repro_torch.configs.base import get_arch as t_get_arch
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.launch.inputs import make_decode_inputs
from repro_torch.models import attention as tattn
from repro_torch.models.base import params_from_numpy, tree_leaves
from repro_torch.models.registry import build_model as t_build_model
from repro_torch.runtime.sharding import Sharder as TSharder
from repro_torch.train.step import make_serve_step as t_make_serve_step


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_biases(tree, rng):
    """Zero-initialised qkv biases would not exercise the bias path."""
    for k in ("bq", "bk", "bv"):
        if k in tree["attn"]:
            tree["attn"][k] = rng.normal(
                scale=0.5, size=tree["attn"][k].shape).astype(np.float32)
    return tree


def _full_smollm_2l(pkg_get_arch):
    return dataclasses.replace(pkg_get_arch("smollm_360m"), n_layers=2,
                               compute_dtype="float32")


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen1_5_110b"])
@pytest.mark.parametrize("window", [None, 5])
def test_attention_decode_matches_jax(arch, window):
    jcfg, tcfg = get_smoke(arch), t_get_smoke(arch)
    rng = np.random.default_rng(11)
    B, max_len, steps = 2, 8, 11  # steps > W: the ring wraps
    params = _randomize_biases(
        {"attn": _np_tree(j_init_tree(jax.random.PRNGKey(0),
                                      jattn.attn_specs(jcfg)))}, rng)["attn"]
    jcache = j_init_tree(jax.random.PRNGKey(1),
                         jattn.cache_specs(jcfg, B, max_len, window=window))
    tcache = params_from_numpy(_np_tree(jcache), device="cpu")
    tparams = params_from_numpy(params, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for t in range(steps):
        x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        pos = np.array([t, t + 3], np.int32)
        jy, jcache = jattn.attention_decode(jparams, jcfg, JSharder(None),
                                            jnp.asarray(x), jcache,
                                            jnp.asarray(pos), window=window)
        ty, tcache = tattn.attention_decode(tparams, tcfg, TSharder(None),
                                            torch.from_numpy(x), tcache,
                                            torch.from_numpy(pos), window=window)
        # fp32, 2e-5 of the output's scale: the projections sum terms of
        # that size in another order in each framework
        want = np.asarray(jy)
        np.testing.assert_allclose(ty.numpy(), want, rtol=2e-5,
                                   atol=2e-5 * max(1.0, np.abs(want).max()))
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                   rtol=2e-5, atol=2e-5)


CONFIGS = {
    "smollm smoke": (get_smoke("smollm_360m"), t_get_smoke("smollm_360m")),
    "qwen1.5 smoke (qkv bias)": (get_smoke("qwen1_5_110b"),
                                 t_get_smoke("qwen1_5_110b")),
    "smollm full width, 2 layers, fp32": (_full_smollm_2l(get_arch),
                                          _full_smollm_2l(t_get_arch)),
}


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_step_matches_jax(name):
    jcfg, tcfg = CONFIGS[name]
    B, max_len, steps = 2, 16, 8
    rng = np.random.default_rng(5)
    jmodel, tmodel = j_build_model(jcfg), t_build_model(tcfg)
    params = _np_tree(j_init_tree(jax.random.PRNGKey(0), jmodel.param_specs(),
                                  jcfg.param_dtype))
    for k in ("bq", "bk", "bv"):
        if k in params["layers"]["attn"]:
            params["layers"]["attn"][k] = rng.normal(
                scale=0.5, size=params["layers"]["attn"][k].shape
            ).astype(np.float32)
    tparams = tmodel.compute_params(params_from_numpy(params, device="cpu"))
    assert [t.shape for t in tree_leaves(tparams)] == [
        a.shape for a in jax.tree_util.tree_leaves(params)]
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstep = jax.jit(j_make_serve_step(jmodel, JSharder(None)))
    tstep = t_make_serve_step(tmodel, TSharder(None))
    jcache = j_init_tree(jax.random.PRNGKey(1), jmodel.cache_specs(B, max_len),
                         jcfg.param_dtype)
    tcache, _, _ = make_decode_inputs(tcfg, B, max_len, torch.Generator(), "cpu")
    toks = rng.integers(0, jcfg.vocab, size=(steps, B)).astype(np.int32)
    for t in range(steps):
        pos = np.full((B,), t, np.int32)
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(toks[t]), jnp.asarray(pos))
        tlog, tcache = tstep(tparams, tcache, torch.from_numpy(toks[t]),
                             torch.from_numpy(pos))
        jl = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy(), jl, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tlog.argmax(-1).numpy(), jl.argmax(-1))
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(tcache["layers"][key].numpy(),
                                   np.asarray(jcache["layers"][key]),
                                   rtol=1e-4, atol=1e-4)


def test_param_specs_keys_and_count_match_jax():
    jcfg, tcfg = get_arch("smollm_360m"), t_get_arch("smollm_360m")
    jspecs = j_build_model(jcfg).param_specs()
    tspecs = t_build_model(tcfg).param_specs()
    jflat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda s: hasattr(s, "axes"))[0]
    tflat = tree_leaves(tspecs)
    assert [tuple(s.shape) for _, s in jflat] == [s.shape for s in tflat]
    assert tcfg.param_count_analytic() == jcfg.param_count_analytic()


def test_compute_params_casts_weights_but_not_norms():
    cfg = t_get_smoke("smollm_360m")
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model = t_build_model(cfg)
    from repro_torch.models.base import init_tree

    params = init_tree(torch.Generator().manual_seed(0), model.param_specs(),
                       device="cpu")
    cp = model.compute_params(params)
    assert cp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert cp["embed"]["tok"].dtype == torch.bfloat16
    assert cp["layers"]["ln1"].dtype == torch.float32
    assert cp["final_norm"].dtype == torch.float32
    torch.testing.assert_close(cp["unembed"], params["unembed"].bfloat16())


@pytest.mark.parametrize("arch", ["qwen2_vl_7b"])
def test_unported_families_name_their_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_build_model(t_get_smoke(arch)).param_specs()
