"""Job kind "serve": one ``InferenceServer`` of the port (continuous
batching over a slot KV cache, prefill teacher-forced through the decode
step, greedy tokens), on weights the benchmark draws from the seed. The
harness puts every server of a cell behind one ``Gateway``.

Its check: a sample, drawn from the seed, of the requests it finished,
the longest among them; the plain reference runs once over each prompt
with its served tokens, and the number is the widest gap by which a
served token's logit lies below the reference's best at its position."""

from __future__ import annotations

import torch

from usfbench.reference.dense import DenseLM, Quant, exact_fp32


class Job:
    kind = "serve"

    def __init__(self, ctx, spec: dict, index: int):
        self.ctx = ctx
        self.spec = spec
        self.index = index
        self.name = f"server{index}"
        self.seed = ctx.seed_for("serve", index)
        self.server = None
        self.params = None
        self.sampled: dict = {}

    def build(self, usf) -> None:
        from repro_torch.serve.engine import InferenceServer

        ctx = self.ctx
        self.params = ctx.make_params(self.seed)
        self.server = InferenceServer(
            self.name, ctx.arch, usf, max_batch=self.spec["max_batch"],
            max_len=self.spec["max_len"], nice=self.spec.get("nice", 10),
            share=self.spec.get("share"), device=ctx.device, params=self.params)

    def start(self) -> None:
        self.server.start()

    def ready(self) -> bool:
        return True

    def tasks(self) -> list:
        return [self.server._task]

    def counters(self) -> dict:
        return {"steps": self.server.steps}

    def stop(self) -> None:
        self.server.stop()

    def free(self) -> None:
        self.server = None

    # ------------------------------------------------------------------ #
    def check(self, ctx, quant: Quant = None) -> dict:
        """{"serve_gap": widest gap} over the sample; with ``quant`` the
        control's reading: at each position of the same prompts and served
        tokens, the gap of the token the quantised reference puts first."""
        done = [s for s in ctx.traffic.sent if s.outputs is not None]
        if not done:
            return {"serve_gap": float("inf")}
        n = min(len(done), ctx.cell["check"]["serve_sample"])
        longest = max(range(len(done)),
                      key=lambda i: len(done[i].prompt) + len(done[i].outputs[self.name]))
        rest = [i for i in range(len(done)) if i != longest]
        pick = [longest] + sorted(ctx.rng_check.choice(rest, size=n - 1, replace=False)
                                  .tolist() if n > 1 else [])
        seqs = [(done[i].prompt, done[i].outputs[self.name]) for i in pick]
        model = DenseLM(ctx.conf)
        worst = 0.0
        tokens = 0
        with torch.no_grad(), exact_fp32():
            for b in range(0, len(seqs), 8):
                block = seqs[b:b + 8]
                S = max(len(p) + len(o) - 1 for p, o in block)
                ids = torch.zeros((len(block), S), dtype=torch.long)
                for r, (p, o) in enumerate(block):
                    row = (p + o)[:-1]
                    ids[r, :len(row)] = torch.tensor(row)
                ref = model.logits(self.params, ids.to(ctx.device))
                ctl = (None if quant is None
                       else model.logits(self.params, ids.to(ctx.device), quant))
                for r, (p, o) in enumerate(block):
                    at = torch.arange(len(p) - 1, len(p) + len(o) - 1, device=ctx.device)
                    lg = ref[r, at]
                    if ctl is None:
                        chosen = torch.tensor(o, device=ctx.device)
                    else:
                        chosen = ctl[r, at].argmax(-1)
                    gap = lg.max(-1).values - lg.gather(-1, chosen[:, None])[:, 0]
                    worst = max(worst, float(gap.max()))
                    tokens += len(o)
        self.sampled = {"requests": len(seqs), "tokens": tokens}
        return {"serve_gap": worst}
