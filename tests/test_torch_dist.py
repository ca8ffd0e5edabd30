"""The port's distributed helpers against the JAX package's, on gloo worlds
of 2–4 CPU processes (spawned; a ``FileStore`` under ``tmp_path``, so
parallel test workers never share a port): ``quantize_int8``,
``dequantize_int8`` and ``topk_compress`` (no world needed), the int8-grid
``compressed_psum`` on four ranks, ``gpipe_forward`` on four ranks, a smoke
forward under a (2, 2) mesh, ``restore_checkpoint(shardings=)`` onto two
ranks, and the two-rank rehearsal of ``chip_smoke.py`` phase 14b at smoke
size (data-parallel step, compressed all-reduce, GPipe, elastic restore,
each against one process).

Tolerances. quantize_int8, dequantize_int8, topk_compress and
compressed_psum: bit for bit (the same fp32 division, round-half-even and
int32 sums; the compressed sum is also held within n · scale / 2 of the
exact one). gpipe_forward: bit for bit (the same stage function on the
same microbatches in each process). The (2, 2) forward: 1e-5 of the
logits' largest |value| (fp32; the sharded products sum in another
order). The phase-14b rehearsal holds its own derived bounds
(``chip_smoke.dp_bounds``)."""

import pickle
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = Path(__file__).resolve().parents[1]


def _entry(rank, name, n, tmp, args):
    """A spawned rank: a gloo group over a file store, then ``name``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", n),
                            rank=rank, world_size=n)
    try:
        out = globals()[name](rank, n, tmp, *args)
        Path(f"{tmp}/out.{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def run_world(name, n, tmp, *args) -> list:
    import torch.multiprocessing as mp

    mp.start_processes(_entry, args=(name, n, str(tmp), args), nprocs=n,
                       start_method="spawn", join=True)
    return [pickle.loads(Path(f"{tmp}/out.{r}.pkl").read_bytes()) for r in range(n)]


def _inputs(rank, shape, seed=0):
    return np.random.default_rng([seed, rank]).standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------- #
# no world needed
# --------------------------------------------------------------------------- #
CASES = {"normal": (lambda r: r.standard_normal((64, 33)), None),
         "ties at .5 of the grid": (lambda r: np.round(r.standard_normal((40,)) * 4) / 8, None),
         "all zero": (lambda r: np.zeros((5, 7)), None),
         "given scale": (lambda r: r.standard_normal((16, 16)) * 3, 0.01)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantize_int8_matches_jax(case):
    import jax.numpy as jnp

    from repro.runtime.dist import dequantize_int8 as j_deq
    from repro.runtime.dist import quantize_int8 as j_q
    from repro_torch.runtime.dist import dequantize_int8, quantize_int8

    make, scale = CASES[case]
    x = make(np.random.default_rng(3)).astype(np.float32)
    jq, js = j_q(jnp.asarray(x), None if scale is None else jnp.float32(scale))
    tq, ts = quantize_int8(torch.from_numpy(x),
                           None if scale is None else torch.tensor(scale, dtype=torch.float32))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(ts.item()) == np.float32(js)
    np.testing.assert_array_equal(dequantize_int8(tq, ts).numpy(),
                                  np.asarray(j_deq(jq, js)))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_compress_matches_jax(frac):
    import jax.numpy as jnp

    from repro.runtime.dist import topk_compress as j_topk
    from repro_torch.runtime.dist import topk_compress

    g, e = _inputs(0, (32, 50)), _inputs(1, (32, 50)) * 0.1
    js, je = j_topk(jnp.asarray(g), jnp.asarray(e), frac=frac)
    ts, te = topk_compress(torch.from_numpy(g), torch.from_numpy(e), frac=frac)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert (ts != 0).sum() >= max(1, int(g.size * frac))


# --------------------------------------------------------------------------- #
# gloo worlds
# --------------------------------------------------------------------------- #
def _compressed(rank, n, tmp):
    from repro_torch.runtime.dist import compressed_psum

    x = torch.from_numpy(_inputs(rank, (24, 40), seed=7) * (rank + 1))
    return compressed_psum(x).numpy()


def _four(rank, n, tmp):
    """The four-rank workloads, in one world (one spawn for the module)."""
    return {"compressed": _compressed(rank, n, tmp), "pipe": _pipe(rank, n, tmp),
            "forward": _forward_2x2(rank, n, tmp)}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_world("_four", 4, tmp_path_factory.mktemp("four"))


def test_compressed_psum_on_four_ranks(four_ranks):
    import jax.numpy as jnp

    from repro.runtime.dist import quantize_int8 as j_q

    outs = [o["compressed"] for o in four_ranks]
    xs = [_inputs(r, (24, 40), seed=7) * (r + 1) for r in range(4)]
    scale = jnp.maximum(jnp.max(jnp.stack([jnp.max(jnp.abs(jnp.asarray(x))) for x in xs]))
                        / 127.0, 1e-12)
    total = sum(np.asarray(j_q(jnp.asarray(x), scale)[0]).astype(np.int32) for x in xs)
    want = total.astype(np.float32) * np.float32(scale)
    for out in outs:
        np.testing.assert_array_equal(out, want)
        exact = np.sum(xs, axis=0)
        assert np.all(np.abs(out - exact) <= 4 * float(scale) / 2 * (1 + 1e-5))


def _pipe(rank, n, tmp):
    from repro_torch.runtime.pipeline import gpipe_forward

    W = torch.from_numpy(_inputs(rank, (8, 8), seed=11) * 0.5)
    b = torch.from_numpy(_inputs(rank, (8,), seed=12))
    mbs = torch.from_numpy(_inputs(0, (5, 3, 8), seed=13))
    stats = {}
    out = gpipe_forward(None, lambda p, x: torch.tanh(x @ p[0] + p[1]), (W, b), mbs,
                        stats=stats)
    return out.numpy(), stats


def test_gpipe_forward_on_four_ranks_matches_the_sequential_composition(four_ranks):
    outs = [o["pipe"] for o in four_ranks]
    x = torch.from_numpy(_inputs(0, (5, 3, 8), seed=13))
    for r in range(4):
        W = torch.from_numpy(_inputs(r, (8, 8), seed=11) * 0.5)
        b = torch.from_numpy(_inputs(r, (8,), seed=12))
        x = torch.stack([torch.tanh(m @ W + b) for m in x])
    for out, stats in outs:
        np.testing.assert_array_equal(out, x.numpy())
        assert stats["ticks"] == 5 + 4 - 1 and stats["transport"] == "device"


def _forward_2x2(rank, n, tmp):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import get_smoke
    from repro_torch.launch.inputs import batch_axes, make_batch
    from repro_torch.models.base import axes_tree, init_tree
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import Sharder
    from repro_torch.train.step import make_prefill_step

    cfg = get_smoke("smollm_360m")
    model = build_model(cfg)
    specs = model.param_specs()
    params = init_tree(torch.Generator().manual_seed(0), specs, cfg.param_dtype, "cpu")
    batch = make_batch(cfg, 4, 32, torch.Generator().manual_seed(1), "cpu")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    assert n == 4
    sh = Sharder(mesh)
    dparams = sh.place_tree(axes_tree(specs), params)
    dbatch = sh.place_tree(batch_axes(cfg, with_labels=True), batch)
    logits = make_prefill_step(model, sh)(dparams, dbatch)
    full = logits.full_tensor()
    want = make_prefill_step(model, Sharder(None))(params, batch)
    return {"got": full.numpy(), "want": want.numpy(),
            "placements": str(logits.placements),
            "wq": str(dparams["layers"]["attn"]["wq"].placements)}


def test_forward_on_a_2x2_mesh_matches_one_device(four_ranks):
    outs = [o["forward"] for o in four_ranks]
    for out in outs:
        assert out["wq"] == "(Shard(dim=1), Replicate())"  # embed on data; 3 heads stay whole
        scale = np.abs(out["want"]).max()
        np.testing.assert_allclose(out["got"], out["want"], rtol=0, atol=1e-5 * scale)


def _restore(rank, n, tmp):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.configs.base import get_smoke
    from repro_torch.models.base import abstract_tree, shardings_tree, tree_leaves
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import Sharder

    cfg = get_smoke("smollm_360m")
    specs = build_model(cfg).param_specs()
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    sh = Sharder(mesh)
    back = restore_checkpoint(f"{tmp}/ckpt", 3, abstract_tree(specs, cfg.param_dtype),
                              shardings=shardings_tree(specs, sh), mesh=mesh)
    return [(str(t.placements), t.to_local().numpy(), t.full_tensor().numpy())
            for t in tree_leaves(back)]


def test_restore_checkpoint_onto_a_two_rank_mesh(tmp_path):
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.configs.base import get_smoke
    from repro_torch.models.base import init_tree, tree_leaves
    from repro_torch.models.registry import build_model

    cfg = get_smoke("smollm_360m")
    params = init_tree(torch.Generator().manual_seed(5), build_model(cfg).param_specs(),
                       cfg.param_dtype, "cpu")
    save_checkpoint(params, str(tmp_path / "ckpt"), 3)
    outs = run_world("_restore", 2, tmp_path)
    leaves = tree_leaves(params)
    sharded = 0
    for rank, out in enumerate(outs):
        assert len(out) == len(leaves)
        for (pl, loc, full), want in zip(out, leaves):
            np.testing.assert_array_equal(full, want.numpy())
            if pl == "(Shard(dim=0),)":  # the "embed" dim on the data axis
                sharded += 1
                np.testing.assert_array_equal(loc, want.numpy()[rank * len(loc):(rank + 1) * len(loc)])
            else:
                assert pl.startswith("(Shard") or pl == "(Replicate(),)"
    assert sharded > 0


def test_phase_14b_rehearsal_on_two_cpu_ranks():
    """``chip_smoke.py``'s two-rank phase at smoke size on the CPU: the
    data-parallel step and the one after an elastic restore against one
    process, the compressed all-reduce, GPipe over the two ranks."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    with tempfile.TemporaryDirectory() as d:
        opts = {"arch": "smollm_360m", "smoke": True, "device": "cpu",
                "store": f"{d}/store", "out": f"{d}/rank", "ckpt": f"{d}/ckpt",
                "global_batch": 8, "seq_len": 32, "microbatches": 2, "ranks": 2}
        ranks = chip_smoke.run_ranks(opts)
    for r in ranks:
        assert r["ok"], r
        assert r["batch_spec"]["tokens"] == "(Shard(dim=0),)"
        assert r["restored_placements"] == "(Replicate(),)"
        assert r["compressed_worst"] <= 1
        assert r["gpipe"]["ticks"] == 4 + 2 - 1
    assert max(ranks[0]["dp_ratio"].values()) <= 1
    assert max(ranks[0]["elastic_ratio"].values()) <= 1
    assert ranks[0]["gpipe_ratio"] == 0  # the same stages in both runs
