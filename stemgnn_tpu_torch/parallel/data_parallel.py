"""Data-parallel minibatch pretraining (counterpart of
``stemgnn_tpu/parallel/data_parallel.py``).

Every rank holds the whole model and takes its own sampled batch a step;
``train.pretrain_loop.run_pretrain(..., mesh=ranks)`` deals them, batch
``i`` of each group of ``world`` to rank ``i`` (a partial last group is
dropped), as JAX's loop does.  Per step (:func:`make_dp_pretrain_step`):

  * BatchNorm's batch moments (the student's and the teacher's) and the
    VQ's EMA and affine statistics are summed across the ranks, with their
    gradient (JAX's ``axis_name``: the reference's only hot-loop
    collective, STEM-GNN/model/vq.py:666-674); the losses and the
    commitment term stay each rank's own;
  * the gradients are averaged across the ranks (JAX's ``pmean``), and so
    are the float buffers (a safeguard: their statistics were summed
    already), then the clipped AdamW step, the EMA codebook and the teacher
    move on every rank alike;
  * the metrics are averaged across the ranks.

No layout is built (JAX takes the batch layouts only without a mesh,
pretrain_loop.py:300-303), so the step runs no CUDA kernel.
"""

from __future__ import annotations

import torch

from stemgnn_tpu_torch.core.config import PretrainConfig
from stemgnn_tpu_torch.models.pretrain import (ema_update_teacher,
                                               pretrain_forward)
from stemgnn_tpu_torch.ops import scatter
from stemgnn_tpu_torch.parallel import mesh
from stemgnn_tpu_torch.parallel.halo import mean_across, rank_sum
from stemgnn_tpu_torch.vq.quantize import adopt_ema_embed


def replicated_update(model, teacher, opt, cfg: PretrainConfig, ranks,
                      grads_out=None):
    """After a step's backward on every rank: the gradients (zero where a
    parameter got none, as JAX's are) and the float buffers of the student
    and the teacher averaged across ``ranks`` (JAX's ``pmean`` of the
    gradients and the state), the optimizer's step, the EMA codebook
    adopted and the teacher moved.  ``grads_out``, a dict, receives the
    averaged gradients by parameter name before the optimizer (its
    clip)."""
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    mean_across([p.grad for p in params], ranks)
    mean_across([b for m in (model, teacher) for b in m.buffers()
                 if b.is_floating_point()], ranks)
    if grads_out is not None:
        grads_out.update({k: p.grad.detach().clone()
                          for k, p in model.named_parameters()})
    opt.step()
    if cfg.vq.ema_update:
        adopt_ema_embed(model.vq)
    ema_update_teacher(teacher, model.encoder, cfg.sem_encoder_decay)


def make_dp_pretrain_step(cfg: PretrainConfig, bs: int, ranks,
                          generator=None):
    """``step(model, teacher, opt, graph, draws=None)`` on this rank of
    ``ranks`` (JAX ``make_dp_pretrain_step``): ``train.pretrain_loop``'s
    step with the sums and averages of the module docstring; returns the
    losses averaged across the ranks (detached, ``loss`` the total)."""
    from stemgnn_tpu_torch.train.pretrain_loop import augmented, draw_step
    reduce = rank_sum(ranks)

    def step(model, teacher, opt, graph, draws=None):
        if draws is None:
            draws = draw_step(cfg, graph, generator)
        opt.zero_grad()
        loss, losses, _ = pretrain_forward(
            model, teacher, cfg, augmented(cfg, graph, draws), graph, bs=bs,
            draws=draws, generator=generator, reduce=reduce)
        loss.backward()
        replicated_update(model, teacher, opt, cfg, ranks)
        metrics = {**losses, "loss": loss}
        keys = list(metrics)
        flat = torch.stack([metrics[k].detach().float() for k in keys])
        mean_across([flat], ranks)
        return dict(zip(keys, flat.unbind()))

    return step


def _dp_rank(ranks, merged, cfg, kw):
    """One rank of :func:`launch_dp_pretrain`: ``run_pretrain`` over the
    ranks; each returns its history, its parameters' digest and the kernel
    launches of its run (and its peak device GB), rank 0 also the model and
    teacher on the CPU."""
    from stemgnn_tpu_torch.parallel.halo_pretrain import params_digest
    from stemgnn_tpu_torch.train.pretrain_loop import run_pretrain
    for name in scatter.launch_counts:
        scatter.launch_counts[name] = 0
    model, teacher, history = run_pretrain(merged, cfg, mesh=ranks,
                                           device=ranks.device, **kw)
    out = {"rank": ranks.rank, "world": ranks.world,
           "backend": ranks.backend, "device": str(ranks.device),
           "history": history, "digest": params_digest(model, teacher),
           "launches": dict(scatter.launch_counts)}
    if ranks.device.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(ranks.device) / 1e9
    if ranks.rank == 0:
        out.update(model=model.cpu(), teacher=teacher.cpu())
    return out


def launch_dp_pretrain(merged, cfg: PretrainConfig, device_type: str,
                       world=None, **kw) -> list:
    """``run_pretrain(..., mesh=ranks)`` on ``world`` ranks (default
    :func:`~stemgnn_tpu_torch.parallel.mesh.data_world`): the ranks' records
    in rank order (this process's alone under torchrun).  Prints the
    backend and each rank's device first."""
    world = mesh.data_world(device_type) if world is None else world
    env = mesh.env_world()
    if env is None or env["rank"] == 0:
        print(f"Data-parallel over {world} devices: "
              f"{mesh.describe_world(world, device_type)}", flush=True)
    return mesh.launch(_dp_rank, world, device_type, merged, cfg, kw)
