"""The pretrain optimizer (counterpart of ``stemgnn_tpu/train/optim.py``):
AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay) after a
global-norm clip, with the reference's cosine LambdaLR ``(1 + cos(e * pi /
E)) / 2`` (STEM-GNN/utils/others.py:138-145, pretrain.py:62,134-136).

The clip is optax's ``clip_by_global_norm``: when the global norm reaches
``max_norm`` every gradient becomes ``g / norm * max_norm``.  It is not
``torch.nn.utils.clip_grad_norm_``, whose ``max_norm / (norm + 1e-6)``
differs from it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def cosine_lambda(epochs: int):
    """lr factor at optimizer step ``step``: ``(1 + cos(min(step, E) * pi /
    E)) / 2``, one epoch a step, as the JAX pretrain loop steps it
    (``steps_per_epoch=1``, pretrain_loop.py:214-216)."""
    def fn(step):
        return (1.0 + math.cos(min(step, epochs) * math.pi / epochs)) * 0.5
    return fn


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float):
    """Scale the gradients of ``params`` as optax's clip does; returns the
    global norm before the clip (f32, 0-dim)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
    for g in grads:
        # (g / norm) * max_norm as optax forms it, or g itself below the norm
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


class Optimizer:
    """AdamW + the optional clip and cosine schedule over ``params`` (a list
    of tensors), as the JAX package's ``make_optimizer`` chains them.
    :meth:`step` gives every parameter without a gradient a zero one first,
    so it decays and keeps its moments as the JAX optimizer (which sees a
    zero gradient for it) does."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 grad_clip: Optional[float] = None,
                 use_scheduler: bool = False, epochs: int = 1):
        self.params = list(params)
        self.grad_clip = grad_clip
        self.opt = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)
        self.sched = (torch.optim.lr_scheduler.LambdaLR(
            self.opt, cosine_lambda(epochs))
            if use_scheduler else None)

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip is not None and self.grad_clip > 0:
            clip_by_global_norm(self.params, self.grad_clip)
        self.opt.step()
        if self.sched is not None:
            self.sched.step()

    def state_tree(self) -> dict:
        """The optimizer's state as numpy arrays, for a checkpoint: AdamW's
        step count and moments per parameter (in ``params`` order), the
        learning rate and the schedule's step."""
        out = {"step": [], "exp_avg": [], "exp_avg_sq": []}
        for p in self.params:
            st = self.opt.state.get(p) or {
                "step": torch.zeros(()), "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}
            out["step"].append(np.asarray(float(st["step"]), np.float32))
            for k in ("exp_avg", "exp_avg_sq"):
                out[k].append(st[k].detach().cpu().numpy())
        out["lr"] = np.asarray(self.opt.param_groups[0]["lr"])
        out["sched_step"] = np.asarray(
            0 if self.sched is None else self.sched.last_epoch)
        return out

    def load_state_tree(self, tree: dict):
        """Restore :meth:`state_tree`'s arrays, bit for bit."""
        if len(tree["step"]) != len(self.params):
            raise ValueError(f"optimizer state of {len(tree['step'])} "
                             f"parameters for {len(self.params)}")
        for p, step, m, v in zip(self.params, tree["step"], tree["exp_avg"],
                                 tree["exp_avg_sq"]):
            self.opt.state[p] = {
                "step": torch.tensor(float(step), dtype=torch.float32),
                "exp_avg": torch.from_numpy(np.array(m)).to(p.device),
                "exp_avg_sq": torch.from_numpy(np.array(v)).to(p.device)}
        lr = float(tree["lr"])
        for group in self.opt.param_groups:
            group["lr"] = lr
        if self.sched is not None:
            sd = self.sched.state_dict()
            n = int(tree["sched_step"])
            sd.update(last_epoch=n, _step_count=n + 1, _last_lr=[lr])
            self.sched.load_state_dict(sd)
