"""LM training: ``repro_torch.models.transformer.Transformer`` trained by
``repro_torch.launch.steps.make_train_step`` (AdamW in place), one fresh
batch of the traffic's token stream a step, the loss read on the host
after each step.

The weights are the benchmark's, drawn on the card from the seed in the
configuration's dtype and copied into the model's parameters; the
batches come from the frozen copy of the program's synthetic stream.
The reference gets the same weights and batches, made again from the
seed once the program's state is freed.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import generate, work
from ..reference import lm as reference

CHECKED = 3


class Session:
    trace_steps = 2

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.seeds = generate.sub_seeds(seed)
        self.inspect_s = None
        self.tokens = traffic["batch"] * traffic["seq_len"]

    def batch(self, step: int) -> dict:
        b = generate.lm_batch(self.traffic, self.cfg, self.seeds["batches"],
                              step)
        return {k: torch.from_numpy(v).long().to(self.device)
                for k, v in b.items()}

    def weights(self) -> dict:
        return generate.lm_weights(self.cfg, self.seeds["weights"],
                                   self.device)

    # -------------------------------------------------------- set-up ----
    def setup(self) -> None:
        from repro_torch.configs.base import ModelConfig
        from repro_torch.core.tilefusion import api
        from repro_torch.launch import steps
        from repro_torch.models.transformer import Transformer
        from repro_torch.optim import adamw
        self.api = api
        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        mcfg = ModelConfig(**{k: v for k, v in self.cfg.items()
                              if k in fields})
        model = Transformer(mcfg, device="meta").to_empty(device=self.device)
        params = dict(model.named_parameters())
        w0 = self.weights()
        if {k: tuple(p.shape) for k, p in params.items()} != \
                {k: tuple(t.shape) for k, t in w0.items()}:
            raise RuntimeError("the model's parameters differ from the "
                               "benchmark's layout of the configuration")
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(w0[k])
        del w0
        self.opt = self.cfg["optimizer"]
        self.train = steps.make_train_step(model, adamw.OptConfig(
            **{k: v for k, v in self.opt.items() if k != "name"}))
        self.state = adamw.init(model.parameters())
        self.model, self.next = model, 0
        losses = []
        for i in range(CHECKED):
            self.step()
            losses.append(self.last_loss)
            if i == 0:
                grads = {k: float(m.norm()) / (1 - self.opt["b1"])
                         for k, m in zip(params, self.state.mu)}
        w0 = self.weights()
        self.readings = {
            "losses": losses, "grad_norms": grads,
            "change_norms": {k: float((p.detach().float()
                                       - w0[k].float()).norm())
                             for k, p in params.items()}}
        del w0

    # -------------------------------------------------------- window ----
    def step(self) -> int:
        batch = self.batch(self.next)
        self.next += 1
        self.state, m = self.train(self.state, batch)
        self.last_loss = float(m["loss"])
        return self.tokens

    def info(self) -> dict:
        stats = self.api.schedule_cache_stats()
        return {"parameters": sum(p.numel() for p in
                                  self.model.parameters()),
                "tokens_per_step": self.tokens,
                "schedule_cache": {k: stats[k] for k in
                                   ("hits", "misses", "entries",
                                    "transpose_entries")},
                "last_loss": self.last_loss}

    # ---------------------------------------------------------- work ----
    def step_flops(self) -> float:
        return work.lm_step_flops(self.cfg, self.traffic["batch"],
                                  self.traffic["seq_len"])

    def scoped_work(self) -> list:
        return work.lm_band_calls(self.cfg, self.traffic["batch"],
                                  self.traffic["seq_len"])

    # ----------------------------------------------------- reference ----
    def close(self) -> None:
        del self.model, self.train, self.state

    def reference(self, prec: str = "f32", fault: str | None = None) -> dict:
        batches = [self.batch(i) for i in range(CHECKED)]
        return reference.train(self.cfg, self.opt, self.weights(), batches,
                               prec=prec, fault=fault)
