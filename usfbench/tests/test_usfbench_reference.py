"""The plain reference against the port at small size on the CPU, on
weights the benchmark draws from a seed: the full forward's logits, the
served path (teacher-forced prefill and decode through the engine's step)
and the first training steps. And the control, the reference with its
products in float8 in the program's place, fails the cell's limits."""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke
from repro_torch.launch.inputs import make_decode_inputs
from repro_torch.models.registry import build_model
from repro_torch.runtime.sharding import Sharder
from repro_torch.train.step import make_prefill_step, make_serve_step
from usfbench.harness import HERE, program_arch, read_json
from usfbench.reference.dense import DenseLM, exact_fp32, fp8_quant
from usfbench.weights import make_params
from usfbench_smoke import SMOKE_CONF, smoke_context

torch.set_num_threads(min(2, torch.get_num_threads()))


def _setup(seed=2 ** 33 + 5):
    ctx = smoke_context("smollm-360m.serve-with-train")
    conf = ctx.conf
    arch = program_arch(conf)
    model = build_model(arch)
    params = make_params(model.param_specs(), arch.param_dtype, seed, "cpu",
                         conf["initializer_range"])
    return conf, arch, model, params


def test_config_file_sets_the_ports_config():
    conf, arch, _, _ = _setup()
    full = program_arch(read_json(HERE / "configs" / "smollm-360m.json"))
    assert (arch.d_model, arch.n_layers, arch.hd) == (60, 2, 20)
    from repro_torch.configs.base import get_arch

    ref = get_arch("smollm_360m")
    assert (full.d_model, full.n_layers, full.n_heads, full.n_kv_heads, full.d_ff,
            full.vocab, full.hd) == (ref.d_model, ref.n_layers, ref.n_heads,
                                     ref.n_kv_heads, ref.d_ff, ref.vocab, ref.hd)
    assert (full.param_dtype, full.compute_dtype) == ("float32", "bfloat16")


def test_forward_logits_agree():
    conf, arch, model, params = _setup()
    tokens = torch.randint(0, conf["vocab_size"], (2, 24), generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tokens.int(), "positions": torch.arange(24).expand(2, 24).int()}
    got = make_prefill_step(model, Sharder(None))(model.compute_params(params), batch)
    with torch.no_grad(), exact_fp32():
        want = DenseLM(conf).logits(params, tokens)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4), (got - want).abs().max()


def test_decode_through_the_cache_agrees_with_the_full_forward():
    conf, arch, model, params = _setup()
    B, S = 3, 20
    tokens = torch.randint(0, conf["vocab_size"], (B, S), generator=torch.Generator().manual_seed(4))
    step = make_serve_step(model, Sharder(None))
    cache, _, _ = make_decode_inputs(arch, B, 64, torch.Generator().manual_seed(1), "cpu")
    cp = model.compute_params(params)
    got = []
    for t in range(S):
        logits, cache = step(cp, cache, tokens[:, t].int(), torch.full((B,), t, dtype=torch.int32))
        got.append(logits)
    got = torch.stack(got, 1)
    with torch.no_grad(), exact_fp32():
        want = DenseLM(conf).logits(params, tokens)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4), (got - want).abs().max()


def test_smoke_conf_is_a_cut_of_the_cells():
    assert set(SMOKE_CONF) <= set(read_json(HERE / "configs" / "smollm-360m.json"))


@pytest.mark.parametrize("workload", ["smollm-360m.serve-with-train", "smollm-360m.train-pair"])
def test_control_fails_the_cells_limits(workload):
    """At smoke size the port computes in float32, as the reference; the
    control, the reference in float8, must still fail one of the cell's
    numbers."""
    from usfbench.harness import setup, stop, window
    from usfbench.jobs.train import compare

    ctx = smoke_context(workload, seconds=2.0)
    setup(ctx)
    window(ctx, log=lambda m: None)
    stop(ctx)
    limits = ctx.cell["limits"]
    failed = []
    for j in ctx.jobs:
        if j.kind == "serve":
            got = j.check(ctx, quant=fp8_quant)
        else:
            got = compare(j.reference(ctx, quant=fp8_quant), j.reference(ctx))
        failed += [k for k, v in got.items() if v > limits[k]]
    assert failed, "the control passed every limit"
