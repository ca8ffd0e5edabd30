"""Port parity for the data stream, checkpoints and the Trainer: ``batch_at``
bit for bit against the JAX package's, checkpoints on the JAX layout in
both directions (bf16 as raw bytes, ``keep``, atomic rename), a JAX
checkpoint resumed by the port's Trainer against JAX's own run, twins of
the JAX trainer's tests (tests/test_substrates.py), the async
checkpointer's snapshot, two Trainers co-executed under the port's
UsfRuntime, and the trainer's device rule."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as j_restore_checkpoint
from repro.ckpt import save_checkpoint as j_save_checkpoint
from repro.configs.base import get_smoke as j_get_smoke
from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.ckpt import (AsyncCheckpointer, latest_step, restore_checkpoint,
                              save_checkpoint)
from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.configs.base import get_smoke
from repro_torch.core.policies import SchedCoop
from repro_torch.core.task import Job
from repro_torch.core.threads import UsfRuntime
from repro_torch.core.topology import Topology
from repro_torch.data.pipeline import PrefetchLoader, SyntheticLMDataset
from repro_torch.models.base import tree_leaves
from repro_torch.train.trainer import Trainer, TrainerConfig

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["smollm_360m", "hubert_xlarge", "qwen2_vl_7b"])
@pytest.mark.parametrize("shards", [(1, 0), (2, 1)])
def test_batch_at_equals_jax_bit_for_bit(arch, shards):
    """Tokens, frame embeddings (hubert) and patch embeddings with [3,B,S]
    M-RoPE positions (qwen2-vl)."""
    n, shard = shards
    kw = dict(global_batch=4, seq_len=24, seed=5, n_shards=n, shard=shard)
    jds, tds = JDataset(j_get_smoke(arch), **kw), SyntheticLMDataset(get_smoke(arch), **kw)
    for step in (0, 3, 17):
        want, got = jds.batch_at(step), tds.batch_at(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    assert got["positions"].shape == ((3, 2 // n * 2, 24) if arch == "qwen2_vl_7b"
                                      else (4 // n, 24))


def test_prefetch_loader_replays_the_stream_from_its_start_step():
    ds = SyntheticLMDataset(get_smoke("smollm_360m"), global_batch=2, seq_len=8)
    loader = PrefetchLoader(ds, start_step=3)
    try:
        for step in (3, 4, 5):
            np.testing.assert_array_equal(loader.get()["tokens"],
                                          ds.batch_at(step)["tokens"])
    finally:
        loader.stop()
    assert not loader._thread.is_alive()


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #
def _state():
    """A state tree with fp32, bf16 and int32 leaves, a 0-d step and a
    list, like the JAX test's."""
    return {
        "step": torch.tensor(7, dtype=torch.int32),
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": (torch.arange(4) / 3).to(torch.bfloat16)},
        "opt": {"m": [torch.zeros(2), torch.full((3,), 2.5)],
                "count": torch.tensor(3, dtype=torch.int32)},
    }


def _leaves(tree):
    return list(ckpt_mod._flatten(tree).values())


def test_checkpoint_roundtrip_keeps_values_and_dtypes(tmp_path):
    state = _state()
    save_checkpoint(state, str(tmp_path), 7)
    assert latest_step(str(tmp_path)) == 7
    target = {"step": torch.zeros((), dtype=torch.int32),
              "params": {"w": torch.zeros(3, 4), "b": torch.zeros(4, dtype=torch.bfloat16)},
              "opt": {"m": [torch.ones(2), torch.ones(3)],
                      "count": torch.zeros((), dtype=torch.int32)}}
    back = restore_checkpoint(str(tmp_path), 7, target)
    for a, b in zip(_leaves(state), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(back["opt"]["m"], list)
    wrong = {**target, "params": {**target["params"], "w": torch.zeros(4, 3)}}
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), 7, wrong)


def test_checkpoint_keep_last_k(tmp_path):
    state = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(state, str(tmp_path), s, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000004",
                                                          "step_00000005"]


def _jax_state(state):
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    return jax.tree_util.tree_map(leaf, state, is_leaf=lambda x: isinstance(x, torch.Tensor))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    state = _state()
    j_save_checkpoint(_jax_state(state), str(tmp_path), 7)
    back = restore_checkpoint(str(tmp_path), 7, state)
    for a, b in zip(_leaves(state), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_checkpoint_restores_in_jax(tmp_path):
    state = _state()
    save_checkpoint(state, str(tmp_path), 7)
    want = _jax_state(state)
    target = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), want)
    back = j_restore_checkpoint(str(tmp_path), 7, target)
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def test_async_checkpointer_writes_the_snapshot_taken_at_save(tmp_path, monkeypatch):
    """The port's optimizer updates in place while the writer runs, so
    ``save`` must copy on the caller's thread."""
    go = threading.Event()
    write = ckpt_mod.save_checkpoint

    def late_write(*args, **kw):
        assert go.wait(timeout=30)
        return write(*args, **kw)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", late_write)
    state = {"w": torch.ones(5), "step": torch.tensor(1, dtype=torch.int32)}
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save(state, 1)
    with torch.no_grad():
        state["w"].mul_(3.0)  # an in-place update after the save
    go.set()
    ck.wait()
    back = restore_checkpoint(str(tmp_path), 1, state)
    assert torch.equal(back["w"], torch.ones(5))


def test_async_checkpointer_raises_the_writers_error_on_wait(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path / "file"))
    (tmp_path / "file").write_text("not a directory")
    ck.save({"w": torch.ones(2)}, 1)
    with pytest.raises(OSError):
        ck.wait()


# --------------------------------------------------------------------------- #
# the Trainer
# --------------------------------------------------------------------------- #
def test_trainer_loss_decreases():
    cfg = get_smoke("smollm_360m")
    t = Trainer(cfg, TrainerConfig(steps=50, global_batch=4, seq_len=64,
                                   ckpt_dir=None, peak_lr=1e-2, warmup=5,
                                   log_every=100), device="cpu")
    t.run(resume=False)
    losses = [m["loss"] for m in t.metrics_log]
    assert all(np.isfinite(losses))
    # structured bigram stream: CE must fall well below the ~5.5 start
    assert np.mean(losses[-5:]) < 4.0


def _trainer(ckpt_dir, steps, **kw):
    return Trainer(get_smoke("smollm_360m"), TrainerConfig(
        steps=steps, global_batch=2, seq_len=32, ckpt_every=5, ckpt_dir=ckpt_dir,
        peak_lr=1e-3, warmup=2, seed=3, **kw), device="cpu")


def test_trainer_crash_restart_is_deterministic(tmp_path):
    """Crash after 10 steps, resume from the checkpoint: the final state
    equals the uninterrupted run's (deterministic data and step)."""
    ref_state = _trainer(None, 14).run(resume=False)
    d = str(tmp_path / "ckpt")
    _trainer(d, 14).run(resume=False, stop_at=10)
    assert latest_step(d) == 10
    resumed = _trainer(d, 14).run(resume=True)
    assert int(resumed["step"]) == 14
    for a, b in zip(tree_leaves(ref_state["params"]), tree_leaves(resumed["params"])):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)


def test_trainer_resumes_a_jax_checkpoint_and_follows_jaxs_run(tmp_path):
    """Both start from JAX's weights (a JAX checkpoint of step 0), and after
    4 steps the port's params equal JAX's uninterrupted run's at the
    train-step tolerance (tests/test_torch_train.py): 1e-5 relative +
    1e-3·lr, but where a gradient is within its rounding of 0, there
    AdamW's normalised update is not resolved, and is bounded by 2·lr a
    step (an update of the other sign). Such elements are rare: under 1%
    of a leaf (0.19% of the embedding's at most here)."""
    kw = dict(steps=4, global_batch=2, seq_len=32, peak_lr=1e-3, warmup=2, seed=3)
    jt = JTrainer(j_get_smoke("smollm_360m"), JTrainerConfig(ckpt_dir=None, **kw))
    d = str(tmp_path / "ckpt")
    j_save_checkpoint(jt.init_state(), d, 0)
    want = jt.run(resume=False)
    port = Trainer(get_smoke("smollm_360m"),
                   TrainerConfig(ckpt_dir=d, ckpt_every=100, **kw), device="cpu")
    got = port.run(resume=True)
    assert int(got["step"]) == 4 and len(port.metrics_log) == 4
    np.testing.assert_allclose([m["loss"] for m in port.metrics_log],
                               [m["loss"] for m in jt.metrics_log], rtol=1e-4)
    lr = kw["peak_lr"]
    for a, b in zip(tree_leaves(got["params"]), jax.tree_util.tree_leaves(want["params"])):
        a, b = a.detach().numpy(), np.asarray(b)
        diff = np.abs(a - b)
        unresolved = diff > 1e-5 * np.abs(b) + 1e-3 * lr
        assert unresolved.mean() < 1e-2
        assert np.all(diff <= 2 * lr * kw["steps"])


def test_two_trainers_co_execute_under_usf():
    """Two Trainers as tasks of two jobs on a one-slot UsfRuntime: the step
    is preemptible and the trainer yields between steps, so both finish."""
    usf = UsfRuntime(Topology(1, 1), SchedCoop(quantum=0.05))
    losses = {}

    def job(name, arch, seed):
        def body():
            t = Trainer(get_smoke(arch), TrainerConfig(
                steps=6, global_batch=2, seq_len=32, peak_lr=1e-2, warmup=2,
                seed=seed), usf=usf, device="cpu")
            t.run(resume=False)
            losses[name] = [m["loss"] for m in t.metrics_log]

        return body

    try:
        tasks = [usf.create(job("a", "smollm_360m", 0), job=Job("job-a"), name="a"),
                 usf.create(job("b", "h2o_danube_3_4b", 1), job=Job("job-b"), name="b")]
        for t in tasks:
            assert usf.join(t, timeout=120.0)
        assert usf.stats()["yields"] > 0
    finally:
        usf.shutdown()
    assert sorted(losses) == ["a", "b"]
    assert all(len(v) == 6 and np.all(np.isfinite(v)) for v in losses.values())


def test_trainer_runs_on_the_card_unless_told_otherwise():
    cfg, tcfg = get_smoke("smollm_360m"), TrainerConfig(steps=1)
    if torch.cuda.is_available():
        assert Trainer(cfg, tcfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg, tcfg)
    assert Trainer(cfg, tcfg, device="cpu").device == torch.device("cpu")
