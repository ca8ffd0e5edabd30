"""The training batches, made from the seed as the trainer's synthetic
stream makes them: a bigram rule t_{i+1} = (t_i + 31) mod V from a random
start on each row, with 2% of the tokens replaced by random ones. A copy
of the port's ``SyntheticLMDataset.batch_at``, so the reference draws its
inputs without the program; the harness checks that both give the same
rows."""

from __future__ import annotations

import numpy as np


def batch_at(seed: int, step: int, *, batch: int, seq_len: int,
             vocab: int) -> dict:
    rng = np.random.default_rng(seed * 1_000_003 + step)
    start = rng.integers(0, vocab, size=(batch, 1))
    idx = np.arange(seq_len + 1)[None, :]
    toks = (start + 31 * idx) % vocab
    noise = rng.random((batch, seq_len + 1)) < 0.02
    toks = np.where(noise, rng.integers(0, vocab, size=(batch, seq_len + 1)), toks)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
