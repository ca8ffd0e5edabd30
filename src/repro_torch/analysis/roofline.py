"""Roofline terms of a step on NVIDIA H100 SXM cards (the port's target):

    compute    = FLOPs_global       / (chips x 989e12 FLOP/s, dense bf16)
    memory     = bytes_global       / (chips x 3.35e12 B/s HBM3)
    collective = coll_bytes_global  / (chips x 450e9 B/s NVLink 4)

The dry run counts each device's FLOPs, bytes and collective traffic
(``launch/dryrun.py``); x chips = global. All four rates are the H100 SXM
data sheet's: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of
HBM3, 80 GB of it, and NVLink 4's 900 GB/s a card in both directions,
450 GB/s each way.
"""

from __future__ import annotations

import dataclasses

HW = {
    "peak_flops_bf16": 989e12,   # per card, dense (no sparsity)
    "hbm_gbps": 3.35e12,         # per card
    "ici_gbps": 450e9,           # NVLink 4, per card and direction
    "hbm_bytes": 80 * 10**9,     # per card
}


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    chips: int
    flops_global: float
    bytes_global: float
    coll_bytes_global: float
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def step_time_s(self) -> float:
        """Lower bound assuming no overlap of the dominant term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: a remat/redundancy waste detector."""
        return self.model_flops / self.flops_global if self.flops_global else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-flops utilization at the roofline step time."""
        cap = self.step_time_s * self.chips * HW["peak_flops_bf16"]
        return self.model_flops / cap if cap else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(
            dominant=self.dominant,
            step_time_s=self.step_time_s,
            useful_flops_ratio=self.useful_flops_ratio,
            mfu_bound=self.mfu_bound,
        )
        return d


def roofline_terms(
    *,
    flops_per_device: float,
    bytes_per_device: float,
    coll_traffic_per_device: float,
    chips: int,
    model_flops: float = 0.0,
) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_device / HW["peak_flops_bf16"],
        memory_s=bytes_per_device / HW["hbm_gbps"],
        collective_s=coll_traffic_per_device / HW["ici_gbps"],
        chips=chips,
        flops_global=flops_per_device * chips,
        bytes_global=bytes_per_device * chips,
        coll_bytes_global=coll_traffic_per_device * chips,
        model_flops=model_flops,
    )


def model_flops_analytic(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N_active D (inference fwd); KV reads
    are a memory, not FLOP, term. N counts active params for MoE."""
    import math

    from repro_torch.models.base import is_spec, param_count
    from repro_torch.models.registry import build_param_specs

    specs = build_param_specs(cfg)
    n_total = param_count(specs)
    if cfg.family == "moe":
        # active = total - inactive routed experts; routed expert weights
        # carry an "experts" axis (the router is skipped)
        routed = 0

        def walk(tree):
            nonlocal routed
            if is_spec(tree):
                if "experts" in tree.axes:
                    routed += math.prod(tree.shape)
                return
            if isinstance(tree, dict):
                for k, v in tree.items():
                    if k == "router":
                        continue
                    walk(v)

        walk(specs)
        n_active = n_total - routed + routed * (cfg.top_k / max(cfg.n_experts, 1))
    else:
        n_active = n_total

    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per row
    return 2.0 * n_active * shape.global_batch
