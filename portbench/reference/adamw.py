"""Plain AdamW as the training cell's file states it: a linear warm-up then
a cosine decay to ``min_lr_ratio`` of the rate; gradients clipped to a
global norm of ``grad_clip``; bias-corrected moments in float32; decoupled
weight decay on every leaf of two dims or more (in the program's stacked
layout that includes the per-layer vectors).  Imports nothing of the
program."""
from __future__ import annotations

import math

import torch


class AdamW:
    def __init__(self, cfg: dict, params: list):
        self.cfg = dict(cfg)
        self.params = params
        self.m = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.v = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.count = 0

    def lr(self, step: int) -> float:
        c = self.cfg
        warm = min(step / max(c.get("warmup_steps", 100), 1), 1.0)
        total, wu = c.get("total_steps", 10_000), c.get("warmup_steps", 100)
        prog = min(max((step - wu) / max(total - wu, 1), 0.0), 1.0)
        ratio = c.get("min_lr_ratio", 0.1)
        decay = ratio + (1 - ratio) * 0.5 * (1 + math.cos(math.pi * prog))
        return c.get("learning_rate", 3e-4) * warm * decay

    @torch.no_grad()
    def step(self, grads) -> torch.Tensor:
        """One update; returns the clip factor it applied."""
        c = self.cfg
        b1, b2 = c.get("beta1", 0.9), c.get("beta2", 0.95)
        eps, wd = c.get("eps", 1e-8), c.get("weight_decay", 0.1)
        self.count += 1
        lr = self.lr(self.count)
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        clip = torch.clamp(c.get("grad_clip", 1.0) / torch.clamp(norm, min=1e-9), max=1.0)
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g.float() * clip
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if p.dim() >= 2:
                upd = upd + wd * p.float()
            p.sub_(lr * upd)
        return clip
