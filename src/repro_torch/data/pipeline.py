"""Data pipeline: deterministic synthetic LM stream + prefetching loader.

Port of ``repro/data/pipeline.py``: ``batch_at`` is numpy and gives the
JAX package's batches bit for bit; ``to_tensors`` puts one on a device.

* Determinism: batch(step) depends only on (seed, step, shard) — restart
  from a checkpoint replays the exact stream.
* The loader's wait for a batch is an *intercepted blocking point*: when
  running under a USF runtime, a stalled input pipeline releases the
  job's slots to co-located jobs (the paper's "fill the gaps" §5.6)
  instead of spinning.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core.autockpt import maybe_checkpoint


class SyntheticLMDataset:
    """Markov-ish synthetic token stream with learnable structure (so smoke
    training runs show decreasing loss, not noise-floor flailing)."""

    def __init__(self, cfg, *, global_batch: int, seq_len: int,
                 seed: int = 0, n_shards: int = 1, shard: int = 0):
        if global_batch % n_shards:
            raise ValueError(f"global batch {global_batch} does not split into "
                             f"{n_shards} shards")
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.n_shards = n_shards
        self.shard = shard
        self.local_batch = global_batch // n_shards

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * self.n_shards + self.shard
        )
        B, S, V = self.local_batch, self.seq_len, cfg.vocab
        # structured stream: a global bigram rule t_{i+1} = (t_i + 31) mod V
        # with 2% noise — compressible, so CE falls quickly below ln(V)
        start = rng.integers(0, V, size=(B, 1))
        idx = np.arange(S + 1)[None, :]
        toks = (start + 31 * idx) % V
        noise = rng.random((B, S + 1)) < 0.02
        toks = np.where(noise, rng.integers(0, V, size=(B, S + 1)), toks)
        batch: dict[str, Any] = {}
        if cfg.frontend == "token":
            batch["tokens"] = toks[:, :-1].astype(np.int32)
        else:
            d_in = cfg.frontend_dim or cfg.d_model
            batch["embeds"] = rng.standard_normal(
                (B, S, d_in), dtype=np.float32
            )
        batch["labels"] = toks[:, 1:].astype(np.int32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        if cfg.mrope_sections is not None:
            pos = np.broadcast_to(pos, (3, B, S))
        batch["positions"] = pos
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def to_tensors(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """A ``batch_at`` batch as tensors on ``device`` (the broadcast
    positions made contiguous first)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class PrefetchLoader:
    """Background-thread prefetch with a bounded queue.

    ``usf`` (optional): a UsfRuntime — ``get()`` then blocks cooperatively
    (CoopEvent) so a data stall yields the slot instead of busy-waiting.
    """

    def __init__(self, dataset: SyntheticLMDataset, *, depth: int = 2,
                 start_step: int = 0, usf=None):
        self.dataset = dataset
        self._q: "queue.Queue[dict]" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = False
        self._usf = usf
        # the generation-counter checkpoint tier (a hot loop outside the
        # step): the fill thread is a plain thread today, so the tick
        # no-ops — but the instrumentation is unconditional, so if the
        # loader is ever hosted on a gated task it is already revocable at
        # batch granularity (docs/PREEMPTION.md tier 3)
        self._tick = (maybe_checkpoint(usf, every=4) if usf is not None
                      else None)
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        step = self._step
        while not self._stop:
            if self._tick is not None:
                self._tick()
            batch = self.dataset.batch_at(step)
            while not self._stop:
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self) -> dict:
        if self._usf is not None and self._usf.current_task() is not None:
            # cooperative wait: poll + nosv_waitfor-style timed block (§4.3.4)
            while True:
                try:
                    return self._q.get_nowait()
                except queue.Empty:
                    self._usf.sleep(0.002)
        return self._q.get()

    def stop(self) -> None:
        self._stop = True
        self._thread.join(timeout=5.0)
