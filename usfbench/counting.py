"""The yardstick's arithmetic: the card's published peaks, the model
operations of a token, and the least time a kernel launch could take.

Peaks are NVIDIA's data sheet for one H100 SXM (dense tensor-core rates,
no sparsity), at the full 700 W power limit; the run prints the card's
limit beside every share of them."""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ES = {"bfloat16": 2, "float32": 4}


def causal_pairs(S: int) -> int:
    """Unmasked (query, key) pairs of one causal sequence of S tokens."""
    return S * (S + 1) // 2


def matmul_params(conf: dict) -> int:
    """Weights a token multiplies by: the layers' projections and MLP and
    the output matrix (the embedding lookup is no product)."""
    d, ff = conf["hidden_size"], conf["intermediate_size"]
    H, KV = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // H
    layer = d * H * hd * 2 + d * KV * hd * 2 + 3 * d * ff
    return conf["num_hidden_layers"] * layer + d * conf["vocab_size"]


def attention_flops_per_seq(conf: dict, S: int) -> int:
    """Forward flops of causal attention over one sequence of S tokens:
    Q.K^T and P.V, two flops a multiply-add, over the unmasked pairs."""
    H = conf["num_attention_heads"]
    hd = conf.get("head_dim") or conf["hidden_size"] // H
    return conf["num_hidden_layers"] * 4 * H * hd * causal_pairs(S)


def train_flops_per_token(conf: dict, S: int) -> float:
    """Model flops of training on a token of sequences of S tokens: 6 a
    weight (forward and the two backward products), and three times the
    causal attention's forward. Remat's recompute is not counted."""
    return 6 * matmul_params(conf) + 3 * attention_flops_per_seq(conf, S) / S


def flash_fwd_bound_s(B: int, S: int, H: int, KV: int, D: int, dtype: str) -> float:
    """Least time of one causal attention forward launch: Q read and O
    written, K and V read, once each; 4 flops a head dim a pair."""
    moved = (2 * B * S * H * D + 2 * B * S * KV * D) * ES[dtype]
    flops = 4 * B * H * D * causal_pairs(S)
    return max(moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
