"""The port's dry run (``launch/dryrun.py``) and elastic demo
(``launch/elastic.py``): cells traced on fake DTensors in a fake world,
with the keys and checks of the JAX package's integration tests
(``tests/test_dryrun_integration.py``), the FLOP count of a one-card trace
against a real step's, the live-memory tally on a case worked by hand, the
probe pairs, a failing cell recorded as an error, and the
CLI. The full-width and production-mesh runs are ``slow``, as the JAX
package's are.

Every count here is exact: the FLOPs of a traced step equal
``FlopCounterMode``'s of the real step on the same aten ops."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

from repro_torch.configs.base import SHAPES, ShapeConfig, get_arch, get_smoke, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import probe_pair, run_cell

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ShapeConfig("train_smoke", 32, 8, "train")
#: a smoke config's cells: each kind at a few tokens
SMOKE_SHAPES = {s.name: s for s in (TRAIN, ShapeConfig("prefill_smoke", 32, 8, "prefill"),
                                    ShapeConfig("decode_smoke", 64, 8, "decode"))}


def assert_jax_keys(out):
    """What the JAX package's integration test asserts of an ok cell."""
    assert out["status"] == "ok", out.get("traceback")
    r = out["roofline"]
    assert r["flops_global"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert 0 < r["useful_flops_ratio"] <= 1.5
    assert out["full"]["memory"]["peak_bytes_est"] > 0
    for key in ("arch", "arch_name", "shape", "mesh", "kind", "microbatches",
                "fsdp_gather", "explicit_sp", "remat", "param_dtype"):
        assert key in out


def test_smoke_train_cell_on_the_debug_mesh():
    out = run_cell("smollm_360m", TRAIN, debug_mesh=True, microbatches=2,
                   cfg=get_smoke("smollm_360m"), verbose=False)
    assert_jax_keys(out)
    assert out["mesh"] == "debug" and out["roofline"]["chips"] == 8
    assert out["probes"]["derived"]["per_layer_flops"] > 0
    # the layers are unrolled: the probes' total is the full count
    assert out["probes"]["check"]["equal"]
    # the gradients are reduced over the data axis, the FSDP shards gathered
    kinds = out["full"]["collectives_raw"]["by_kind"]
    assert kinds["all-reduce"]["count"] > 0 and kinds["all-gather"]["count"] > 0
    assert out["full"]["comm_counts"]["all_reduce"] == kinds["all-reduce"]["count"]
    mem = out["full"]["memory"]
    assert mem["alias_bytes"] > 0  # the state is updated in place
    assert mem["peak_bytes_est"] > mem["argument_bytes"]
    # a rank holds its shards of params, m and v, not the whole state
    from repro_torch.models.base import param_bytes
    from repro_torch.models.registry import build_param_specs

    whole = 3 * param_bytes(build_param_specs(get_smoke("smollm_360m")))
    assert mem["argument_bytes"] < 0.5 * whole


def test_mamba2_decode_cell_on_the_debug_mesh():
    out = run_cell("mamba2_2_7b", ShapeConfig("decode_smoke", 64, 8, "decode"),
                   debug_mesh=True, cfg=get_smoke("mamba2_2_7b"), verbose=False)
    assert_jax_keys(out)
    assert out["probes"]["check"]["equal"]


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen2_vl_7b"])
def test_attention_decode_cell_on_the_debug_mesh(arch):
    """The cache ring split over "kv_batch" and "kv_seq" is written on each
    rank's block (``attention.ring_write``), under M-RoPE too."""
    out = run_cell(arch, ShapeConfig("decode_smoke", 64, 8, "decode"),
                   debug_mesh=True, cfg=get_smoke(arch), probes=False, verbose=False)
    assert_jax_keys(out)


def test_encoder_only_decode_is_recorded_as_a_skip():
    out = run_cell("hubert_xlarge", "decode_32k", debug_mesh=True, verbose=False)
    assert out["status"] == "skip"
    assert "encoder-only" in out["reason"]


def test_a_failing_cell_is_recorded_as_an_error(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("no sharding rule for this op")

    monkeypatch.setattr(dryrun, "_trace", broken)
    out = run_cell("smollm_360m", TRAIN, debug_mesh=True, cfg=get_smoke("smollm_360m"),
                   verbose=False)
    assert out["status"] == "error"
    assert out["error"] == "RuntimeError: no sharding rule for this op"
    assert "broken" in out["traceback"]


@pytest.mark.parametrize("kind", SMOKE_SHAPES)
@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "grok_1_314b"])
def test_moe_cell_on_the_debug_mesh(arch, kind):
    """The routing, dispatch and combine run on each rank's rows
    (``sharding.on_batch_shards``), K3's products on its experts and rows
    (``ops.gmm_on_shards``)."""
    shape = SMOKE_SHAPES[kind]
    out = run_cell(arch, shape, debug_mesh=True, cfg=get_smoke(arch),
                   microbatches=2 if shape.kind == "train" else None, probes=False,
                   verbose=False)
    assert_jax_keys(out)


def test_one_card_trace_counts_the_real_steps_flops():
    """The CPU twin of chip_smoke.py phase 14a: a one-card mesh traces the
    step on plain fake tensors; the real step's FlopCounterMode agrees to
    the FLOP."""
    _one_card_flops("smollm_360m")


def test_one_card_moe_trace_counts_the_real_steps_flops():
    """The same for deepseek-moe-16b smoke: the trash-row dispatch and the
    grouped products count as in the real step."""
    _one_card_flops("deepseek_moe_16b")


def _one_card_flops(arch):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.inputs import make_batch
    from repro_torch.models.base import init_tree
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import Sharder
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_smoke(arch)
    out = run_cell(arch, TRAIN, microbatches=2, probes=False, cfg=cfg,
                   mesh_shape=((1, 1), ("data", "model")), verbose=False)
    assert_jax_keys(out)
    assert out["full"]["collectives_raw"]["n_ops"] == 0
    model = build_model(cfg)
    state = init_train_state(model, init_tree(torch.Generator().manual_seed(0),
                                              model.param_specs(), cfg.param_dtype, "cpu"))
    batch = make_batch(cfg, TRAIN.global_batch, TRAIN.seq_len,
                       torch.Generator().manual_seed(1), "cpu")
    counter = FlopCounterMode(display=False)
    with counter:
        make_train_step(model, Sharder(None), microbatches=2)(state, batch)
    assert counter.get_total_flops() == out["full"]["cost_raw"]["flops"]


def test_tally_counts_bytes_and_the_live_peak():
    """Two 1000-float tensors live at once, rounded to 512-byte blocks:
    the peak is 2 x 4096 bytes; ``a * 2`` reads and writes 4000 bytes
    each, ``b + 1`` too; views and allocations move nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        tally = dryrun._tally_mode()
        with tally:
            a = torch.empty(1000)
            b = a * 2
            del a
            c = b[10:] + 1
            del b, c
    assert tally.peak == 2 * 4096
    assert tally.bytes == 4000 * 2 + 3960 * 2
    assert tally.live == 0


def test_tally_counts_a_ranks_shards_only():
    """In a fake world an op on DTensors reaches the tally as its local op
    only: DTensor's shape propagation on global-shaped stand-ins (paused)
    and the DTensor-level op itself are not device work."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.runtime.sharding import Sharder

    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        sh = Sharder(mesh)
        with FakeTensorMode():
            a = sh.place(torch.empty(64, 256), "batch", "mlp")
            b = sh.place(torch.empty(64, 256), "batch", "mlp")
            tally = dryrun._tally_mode()
            with tally, dryrun._propagation_untallied(tally):
                c = a + b
                d = a * c
    local = 32 * 64 * 4  # a [32, 64] fp32 shard
    assert tuple(d.to_local().shape) == (32, 64)
    assert tally.bytes == 2 * 3 * local
    assert tally.collectives == []


@pytest.mark.parametrize("arch", list_archs())
def test_probe_pairs(arch):
    """1 and 2 layers (MoE: past the dense ones; hybrid: one and two
    superblocks, with the tail), and the multiplier that brings the pair
    to the full depth."""
    cfg = get_arch(arch)
    a, b, mult = probe_pair(cfg)
    step = b.n_layers - a.n_layers
    assert a.n_layers + mult * step == cfg.n_layers
    assert step == (3 if cfg.family == "hybrid" else 1)


def test_elastic_demo_on_a_smoke_config():
    from repro_torch.core import Job, SchedCoop, Topology
    from repro_torch.core.events import SimExecutor
    from repro_torch.launch.elastic import elastic_demo
    from repro_torch.launch.rescale import ElasticCoordinator

    sim = SimExecutor(Topology(8, 1), SchedCoop(quantum=0.01), max_time=1e9)
    coord = ElasticCoordinator()
    lease = coord.register(sim.attach(Job("train"), policy=SchedCoop(quantum=0.01),
                                      share=6.0))
    res = elastic_demo("smollm_360m", ShapeConfig("train_smoke", 32, 16, "train"),
                       verbose=False, coordinator=coord, cfg=get_smoke("smollm_360m"),
                       microbatches=1, meshes=(("full_4x4", (4, 4)),
                                               ("degraded_2x4", (2, 4))))
    assert set(res) == {"full_4x4", "degraded_2x4"}
    assert res["degraded_2x4"]["lease_shares"] == {"train": 3.0}
    assert lease.share == 3.0
    for r in res.values():
        assert r["memory"]["peak_bytes_est"] > 0 and r["flops"] > 0
    # half the cards: each holds more of the batch
    assert res["degraded_2x4"]["flops"] > res["full_4x4"]["flops"]


def test_cli_writes_each_cell_apart_from_the_jax_results(tmp_path):
    rc = dryrun.main(["--debug-mesh", "--arch", "hubert_xlarge", "--shape",
                      "decode_32k", "--out", str(tmp_path)])
    assert rc == 0
    out = json.loads((tmp_path / "hubert_xlarge.decode_32k.debug.json").read_text())
    assert out["status"] == "skip"
    assert dryrun.DEFAULT_OUT == "results/dryrun_torch"
    assert "results/dryrun_torch/" in (ROOT / ".gitignore").read_text().split()


# --------------------------------------------------------------------------- #
# slow: full width, production meshes (as the JAX package's dry-run tests)
# --------------------------------------------------------------------------- #
def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--out", str(tmp_path), *args], capture_output=True,
                          text=True, timeout=3600, env=env, cwd=str(ROOT))


@pytest.mark.slow
def test_full_width_train_cell_on_the_debug_mesh(tmp_path):
    p = _cli(tmp_path, "--debug-mesh", "--arch", "smollm_360m", "--shape", "train_4k")
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    out = json.loads((tmp_path / "smollm_360m.train_4k.debug.json").read_text())
    assert_jax_keys(out)
    assert out["probes"]["derived"]["per_layer_flops"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["smollm_360m", "h2o_danube_3_4b", "qwen1_5_110b",
                                  "command_r_plus_104b"])
def test_dense_train_cells_on_the_production_meshes(tmp_path, arch, multi_pod):
    p = _cli(tmp_path, "--arch", arch, "--shape", "train_4k", "--no-probes",
             *(["--multi-pod"] if multi_pod else []))
    mesh = "2x16x16" if multi_pod else "16x16"
    out = json.loads((tmp_path / f"{arch}.train_4k.{mesh}.json").read_text())
    assert_jax_keys(out)
    assert p.returncode == 0


@pytest.mark.slow
def test_full_size_elastic_demo():
    from repro_torch.launch.elastic import elastic_demo

    res = elastic_demo("smollm_360m", verbose=False)
    assert set(res) == {"full_16x16", "degraded_8x16"}
    assert (res["degraded_8x16"]["memory"]["peak_bytes_est"]
            > res["full_16x16"]["memory"]["peak_bytes_est"])
