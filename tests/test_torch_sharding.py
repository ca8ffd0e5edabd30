"""The port's sharding rules against the JAX package's: ``logical_to_spec``
on a seeded sweep of shapes and axes and on the JAX tests' fixed cases,
every parameter leaf of the ten architectures on the two production
meshes, ``param_count``, ``param_bytes`` and ``model_flops_analytic`` for
every (arch, shape) cell, the dry run's input stand-ins, and the torch
side on its own: DTensor placements, the ``Sharder``'s hooks in a fake
world, and the meshes.

The JAX ``logical_to_spec`` reads only ``mesh.shape.get``, so it is given a
stand-in with a ``.shape`` dict: no fake XLA devices are needed. Every
comparison is exact."""

import random
import types

import numpy as np
import pytest
import torch

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

from repro.analysis.roofline import model_flops_analytic as j_model_flops
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import get_smoke as j_get_smoke
from repro.configs.base import list_archs
from repro.launch import inputs as j_inputs
from repro.models.base import abstract_tree as j_abstract_tree
from repro.models.base import axes_tree as j_axes_tree
from repro.models.base import param_bytes as j_param_bytes
from repro.models.base import param_count as j_param_count
from repro.models.registry import build_param_specs as j_build_param_specs
from repro.runtime.sharding import DEFAULT_RULES as J_RULES
from repro.runtime.sharding import Sharder as JSharder
from repro.runtime.sharding import logical_to_spec as j_logical_to_spec
from repro_torch.analysis.roofline import model_flops_analytic as t_model_flops
from repro_torch.configs.base import SHAPES as T_SHAPES
from repro_torch.configs.base import get_arch as t_get_arch
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.launch import inputs as t_inputs
from repro_torch.launch.mesh import (debug_shape, fake_world, make_debug_mesh,
                                     make_mesh, make_production_mesh,
                                     production_shape)
from repro_torch.models.base import abstract_tree as t_abstract_tree
from repro_torch.models.base import axes_tree as t_axes_tree
from repro_torch.models.base import param_bytes as t_param_bytes
from repro_torch.models.base import param_count as t_param_count
from repro_torch.models.base import shardings_tree
from repro_torch.models.registry import build_param_specs as t_build_param_specs
from repro_torch.runtime.sharding import DEFAULT_RULES as T_RULES
from repro_torch.runtime.sharding import Sharder as TSharder
from repro_torch.runtime.sharding import logical_to_spec, spec_to_placements

MESHES = {
    "debug": {"data": 2, "model": 4},
    "debug multi-pod": {"pod": 2, "data": 2, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x2x2": {"pod": 2, "data": 2, "model": 2},
}


def standin(sizes: dict):
    """What the JAX ``logical_to_spec`` reads of a mesh."""
    return types.SimpleNamespace(shape=dict(sizes))


def j_spec(shape, axes, sizes, rules=None) -> tuple:
    return tuple(j_logical_to_spec(shape, axes, standin(sizes), rules))


def test_default_rules_are_the_jax_table():
    assert T_RULES == J_RULES


# --------------------------------------------------------------------------- #
# logical_to_spec
# --------------------------------------------------------------------------- #
#: the JAX tests' fixed cases (tests/test_sharding_rules.py), with their
#: expected specs
FIXED = [
    ("basic", (64, 128), ("embed", "mlp"), "debug", ("data", "model")),
    ("6 kv heads on a 4-way model axis", (64, 6, 16), ("embed", "kv_heads", None),
     "debug", ("data",)),
    ("batch 1 cannot shard", (1, 128), ("batch", None), "debug", ()),
    ("no axis reuse", (8, 8), ("mlp", "heads"), "debug", ("model",)),
    ("multi-axis batch", (8, 16), ("batch", None), "2x2x2", (("pod", "data"),)),
    ("partial multi-axis", (2, 16), ("batch", None), "2x2x2", ("pod",)),
]


@pytest.mark.parametrize("name,shape,axes,mesh,want", FIXED, ids=[f[0] for f in FIXED])
def test_fixed_cases(name, shape, axes, mesh, want):
    got = logical_to_spec(shape, axes, MESHES[mesh])
    assert got == want
    assert got == j_spec(shape, axes, MESHES[mesh])


_AXES = [None, "unknown"] + sorted(J_RULES)
_DIMS = [1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 512]
_RULE_SETS = {
    "default": None,
    "embed unsharded": {**J_RULES, "embed": ()},
    "batch data-major": {**J_RULES, "batch": ("data", "pod")},
}


@pytest.mark.parametrize("rules", sorted(_RULE_SETS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sweep_matches_jax(mesh, rules):
    rng = random.Random(f"{mesh}/{rules}")
    sizes = MESHES[mesh]
    for _ in range(300):
        rank = rng.randint(1, 4)
        shape = tuple(rng.choice(_DIMS) for _ in range(rank))
        axes = tuple(rng.choice(_AXES) for _ in range(rank))
        want = j_spec(shape, axes, sizes, _RULE_SETS[rules])
        assert logical_to_spec(shape, axes, sizes, _RULE_SETS[rules]) == want, (shape, axes)
        # through the Sharder too, and every kept axis divides its dim
        assert TSharder(sizes, _RULE_SETS[rules]).spec(shape, axes) == want
        for dim, part in zip(shape, want):
            names = () if part is None else (part,) if isinstance(part, str) else part
            assert dim % int(np.prod([sizes[n] for n in names] or [1])) == 0


def test_rank_mismatch_raises():
    with pytest.raises(ValueError):
        logical_to_spec((4, 4), ("batch",), MESHES["debug"])


def test_with_rules_matches_jax():
    sizes = MESHES["16x16"]
    over = {"embed": (), "act_seq": ()}
    for shape, axes in [((4096, 1024), ("embed", "mlp")),
                        ((8, 4096, 1024), ("act_batch", "act_seq", "act_embed"))]:
        assert (TSharder(sizes).with_rules(over).spec(shape, axes)
                == tuple(JSharder(standin(sizes)).with_rules(over).spec(shape, axes)))


# --------------------------------------------------------------------------- #
# every parameter leaf of every arch on the production meshes
# --------------------------------------------------------------------------- #
def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_with_paths(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list_archs())
def test_every_param_leaf_matches_jax(arch, mesh):
    sizes = MESHES[mesh]
    jl = _leaves_with_paths(j_build_param_specs(j_get_arch(arch)))
    tl = _leaves_with_paths(t_build_param_specs(t_get_arch(arch)))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, js), (_, ts) in zip(jl, tl):
        assert (js.shape, js.axes) == (ts.shape, ts.axes), path
        assert TSharder(sizes).spec(ts.shape, ts.axes) == j_spec(js.shape, js.axes, sizes), path


# --------------------------------------------------------------------------- #
# parameter counts, bytes and model FLOPs for every cell
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", list(J_SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_counts_and_model_flops_match_jax(arch, shape):
    jcfg, tcfg = j_get_arch(arch), t_get_arch(arch)
    if J_SHAPES[shape].kind in ("prefill", "decode"):  # the dry run's serving dtype
        import dataclasses

        jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
        tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    jspecs, tspecs = j_build_param_specs(jcfg), t_build_param_specs(tcfg)
    assert t_param_count(tspecs) == j_param_count(jspecs)
    assert t_param_bytes(tspecs, tcfg.param_dtype) == j_param_bytes(jspecs, jcfg.param_dtype)
    assert t_model_flops(tcfg, T_SHAPES[shape]) == j_model_flops(jcfg, J_SHAPES[shape])


@pytest.mark.parametrize("arch", ["command_r_plus_104b", "qwen1_5_110b", "grok_1_314b"])
def test_archs_beyond_the_card_count_as_jax(arch):
    """The three configs a card cannot hold: their byte counts exceed it."""
    specs = t_build_param_specs(t_get_arch(arch))
    assert t_param_bytes(specs) == j_param_bytes(j_build_param_specs(j_get_arch(arch)))
    assert t_param_bytes(specs) > 80 * 10 ** 9


# --------------------------------------------------------------------------- #
# stand-ins: abstract_tree, axes_tree, the inputs
# --------------------------------------------------------------------------- #
def _jdtype(x) -> str:
    return str(np.dtype(x.dtype))


def _tdtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_and_axes_trees_match_jax(arch):
    jspecs = j_build_param_specs(j_get_smoke(arch))
    tspecs = t_build_param_specs(t_get_smoke(arch))
    ja = _leaves_with_paths(j_abstract_tree(jspecs, "float32"))
    ta = _leaves_with_paths(t_abstract_tree(tspecs, "float32"))
    assert [p for p, _ in ja] == [p for p, _ in ta]
    for (path, j), (_, t) in zip(ja, ta):
        assert t.device.type == "meta"
        assert (tuple(j.shape), _jdtype(j)) == (tuple(t.shape), _tdtype(t)), path
    assert _leaves_with_paths(t_axes_tree(tspecs)) == _leaves_with_paths(j_axes_tree(jspecs))


def _j_flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _j_flat(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _j_flat(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("shape", list(J_SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_jax(arch, shape):
    jcfg, tcfg = j_get_arch(arch), t_get_arch(arch)
    if not jcfg.supports_decode and J_SHAPES[shape].kind == "decode":
        with pytest.raises(ValueError):
            t_inputs.input_specs(tcfg, T_SHAPES[shape])
        return
    j = _j_flat(j_inputs.input_specs(jcfg, J_SHAPES[shape]))
    t = _j_flat(t_inputs.input_specs(tcfg, T_SHAPES[shape]))
    assert [p for p, _ in j] == [p for p, _ in t]
    for (path, a), (_, b) in zip(j, t):
        assert b.device.type == "meta", path
        assert (tuple(a.shape), _jdtype(a)) == (tuple(b.shape), _tdtype(b)), path


def test_mrope_positions_are_three_streams():
    cfg = t_get_arch("qwen2_vl_7b")
    assert tuple(t_inputs.batch_specs(cfg, 4, 16, with_labels=True)["positions"].shape) == (3, 4, 16)
    assert tuple(t_inputs.decode_specs(cfg, 4, 16)[2].shape) == (3, 4)


# --------------------------------------------------------------------------- #
# the torch side: placements, meshes, the Sharder's hooks
# --------------------------------------------------------------------------- #
def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert spec_to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert spec_to_placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):  # minor-to-major: DTensor splits in mesh order
        spec_to_placements((("data", "pod"),), mesh)


def test_meshless_sharder_passes_through():
    sh = TSharder(None)
    x = torch.randn(2, 3)
    assert sh.constrain(x, "batch", None) is x
    assert sh.gather(x, "embed", None) is x
    assert sh.sp_boundary(x) is x
    assert sh.spec((4, 4), ("batch", None)) == ()
    with pytest.raises(ValueError):
        sh.sharding((4, 4), ("batch", None))


@pytest.mark.parametrize("which", ["production", "production multi-pod", "debug",
                                   "debug multi-pod"])
def test_meshes_in_a_fake_world(which):
    import torch.distributed as dist

    multi = which.endswith("multi-pod")
    shape, axes = (production_shape if which.startswith("production")
                   else debug_shape)(multi_pod=multi)
    make = make_production_mesh if which.startswith("production") else make_debug_mesh
    with fake_world(int(np.prod(shape))):
        mesh = make(multi_pod=multi, device_type="cpu")
        assert tuple(mesh.shape) == shape and tuple(mesh.mesh_dim_names) == axes
        assert mesh.size() == int(np.prod(shape))
        with pytest.raises(RuntimeError):  # no nested worlds
            with fake_world(2):
                pass
    assert not dist.is_initialized()


def test_sharder_hooks_redistribute_dtensors():
    """In a fake world of 8 on (data=2, model=4): ``place`` puts a leaf on
    its spec, ``constrain`` moves an activation to its axes' spec,
    ``gather`` drops the FSDP axis (only with fsdp_gather), ``sp_boundary``
    gathers the sequence (only with explicit_sp); plain tensors pass."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        sh = TSharder(mesh)
        assert sh.sharding((64, 128), ("embed", "mlp")) == (Shard(0), Shard(1))
        with FakeTensorMode():
            w = sh.place(torch.empty(64, 128), "embed", "mlp")
            assert w.placements == (Shard(0), Shard(1))
            assert tuple(w.to_local().shape) == (32, 32)
            assert sh.gather(w, "embed", "mlp") is w  # fsdp_gather off
            g = TSharder(mesh, fsdp_gather=True).gather(w, "embed", "mlp")
            assert g.placements == (Replicate(), Shard(1))
            x = sh.place(torch.empty(8, 16, 32), "act_batch", None, None)
            y = sh.constrain(x, "act_batch", "act_seq", "act_embed")
            assert y.placements == (Shard(0), Shard(1))
            assert sh.sp_boundary(y) is y
            sp = TSharder(mesh)
            sp.explicit_sp = True
            assert sp.sp_boundary(y).placements == (Shard(0), Replicate())
            plain = torch.empty(8, 16)
            assert sh.constrain(plain, "act_batch", None) is plain


def test_shardings_tree_places_every_leaf():
    specs = t_build_param_specs(t_get_smoke("smollm_360m"))
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        tree = shardings_tree(specs, TSharder(mesh))
        got = [v for _, v in _leaves_with_paths(tree)]
        want = [spec_to_placements(TSharder(mesh).spec(s.shape, s.axes), mesh)
                for _, s in _leaves_with_paths(specs)]
        assert got == want and len(got) == len(_leaves_with_paths(specs))
