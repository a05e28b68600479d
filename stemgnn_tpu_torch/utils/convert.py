"""Weights carried across between the JAX package's pytrees and the port's
modules.

The port's modules name their parameters and buffers after the JAX pytree
paths and keep the same layouts (``Linear.w`` is ``[in, out]`` on both
sides), so a conversion is a rename: ``layers/#0/lin_l/w`` in a checkpoint
is ``layers.0.lin_l.w`` in ``Encoder.state_dict()``.  Nothing is transposed.
A finetune task model adds the ``decoder`` tree (``models.task``).
"""

from __future__ import annotations

import numpy as np
import torch

from stemgnn_tpu_torch.models.task import TaskModel, task_model_init
from stemgnn_tpu_torch.nn.encoder import Encoder
from stemgnn_tpu_torch.vq.quantize import VectorQuantize


def _flat_names(tree, prefix=""):
    """Nested dicts/lists of arrays -> {dotted name: array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat_names(v, f"{prefix}{k}."))
    return out


def _nest(flat: dict):
    """{dotted name: array} -> nested dicts, numeric components as lists."""
    root: dict = {}
    for name, v in flat.items():
        parts = name.split(".")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[k]) for k in sorted(node, key=int)]
        return {k: listify(v) for k, v in node.items()}
    return listify(root)


def _load(module: torch.nn.Module, params, state):
    flat = {**_flat_names(params), **_flat_names(state)}
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in flat.items()},
        strict=True)
    return module


def from_jax_pytree(params_np: dict, state_np: dict, cfg):
    """``params_np``/``state_np`` = ``{"encoder": ..., "vq": ...}`` as the
    JAX package's ``encoder_init``/``vq_init`` (or a loaded ``.npz``) give
    them; ``cfg`` has ``.encoder`` and ``.vq`` configs.  Returns
    ``(Encoder, VectorQuantize)`` on the CPU, in eval mode."""
    enc = _load(Encoder(cfg.encoder), params_np["encoder"],
                state_np["encoder"])
    vq = _load(VectorQuantize(cfg.vq), params_np["vq"], state_np["vq"])
    return enc.eval(), vq.eval()


def task_model_from_jax(params_np: dict, state_np: dict, cfg) -> TaskModel:
    """A :class:`~stemgnn_tpu_torch.models.task.TaskModel` from the JAX
    ``task_model_init`` trees (``{"encoder", "vq", "decoder"}`` params,
    ``{"encoder", "vq"}`` state); ``cfg`` is a FinetuneConfig."""
    enc, vq = from_jax_pytree(params_np, state_np, cfg)
    model = task_model_init(cfg, enc, vq)
    _load(model.decoder, params_np["decoder"], {})
    return model


def _module_trees(module: torch.nn.Module):
    param_names = {n for n, _ in module.named_parameters()}
    sd = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}
    return (_nest({k: v for k, v in sd.items() if k in param_names}),
            _nest({k: v for k, v in sd.items() if k not in param_names}))


def to_jax_pytree(encoder: Encoder, vq: VectorQuantize):
    """The reverse direction: ``(params, state)`` as nested numpy trees in
    the JAX package's form, e.g. for ``utils.checkpoint.save_pytree``."""
    ep, es = _module_trees(encoder)
    vp, vs = _module_trees(vq)
    return {"encoder": ep, "vq": vp}, {"encoder": es, "vq": vs}


def task_model_to_jax(model: TaskModel):
    """``(params, state)`` of a task model in the JAX package's form."""
    params, state = to_jax_pytree(model.encoder, model.vq)
    params["decoder"] = _module_trees(model.decoder)[0]
    return params, state
