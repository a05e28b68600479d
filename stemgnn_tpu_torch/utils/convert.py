"""Weights carried across between the JAX package's pytrees and the port's
modules.

The port's modules name their parameters and buffers after the JAX pytree
paths and keep the same layouts (``Linear.w`` is ``[in, out]`` on both
sides), so a conversion is a rename: ``layers/#0/lin_l/w`` in a checkpoint
is ``layers.0.lin_l.w`` in ``Encoder.state_dict()``.  Nothing is transposed.
Each layer kind keeps JAX's tree: ``{"lin_l", "lin_r"}`` for sage,
``{"weights"}`` for an MoE-SAGE layer (its router in ``env_encoders``, a
list JAX leaves empty without MoE layers, so it has no leaf then),
``{"lin", "bias"}`` for gcn, ``{"lin", "eps"}`` for gin (``eps`` 0-dim) and
``{"lin", "att_src", "att_dst", "bias"}`` for gat.  A finetune task model
adds the ``decoder`` tree (``models.task``); a pretrain model the decoders
of ``models.pretrain`` and a teacher encoder whose BatchNorm statistics are
the JAX state's ``sem_encoder``.  The VQ's buffers are JAX's VQ state
(``embed_avg``, ``cluster_size``, ``initted``, and as configured
``embed_target`` and the affine statistics), so they cross both ways with
the parameters.  The language models of the text
encoders (``nn/{distilbert,bert,llama}.py``) name theirs after the JAX
pytrees too (``layers.0.q.w``, ``[in, out]``): :func:`language_model_from_jax`.
The OFA zoo's modules (``zoo/*``, ``ofa/heads.py``, ``ofa/train.py``)
keep the trees of ``gnn_stack_init``, ``mlp_init``, ``attention_pool_init``,
``graph_predictor_init``, ``bin_graph_init`` and ``ofa_train_eval``'s
``{"enc", "head"}``; their shapes give every constructor argument, so each
``*_from_jax`` needs the trees alone.
"""

from __future__ import annotations

import numpy as np
import torch

from stemgnn_tpu_torch.models.pretrain import PretrainModel
from stemgnn_tpu_torch.models.task import TaskModel, task_model_init
from stemgnn_tpu_torch.nn.bert import BertConfig, BertModel
from stemgnn_tpu_torch.nn.distilbert import (DistilBertConfig,
                                             DistilBertModel, load_into)
from stemgnn_tpu_torch.nn.encoder import Encoder
from stemgnn_tpu_torch.nn.llama import LlamaConfig, LlamaModel
from stemgnn_tpu_torch.ofa.heads import BinGraphHead
from stemgnn_tpu_torch.ofa.train import OFAModel
from stemgnn_tpu_torch.vq.quantize import VectorQuantize
from stemgnn_tpu_torch.zoo.mlp import MLP
from stemgnn_tpu_torch.zoo.pooling import AttentionPool
from stemgnn_tpu_torch.zoo.predictors import Predictor
from stemgnn_tpu_torch.zoo.stack import GNNStack


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
    ``(Encoder, VectorQuantize)`` on the CPU, in eval mode.  The VQ state
    of an EMA-trained codebook carries ``embed_target``; a VQ configured
    without ``ema_update`` (a finetune of that checkpoint) drops it, as
    JAX's VQ never reads it then."""
    enc = _load(Encoder(cfg.encoder), params_np["encoder"],
                state_np["encoder"])
    vq_state = dict(state_np["vq"])
    if not cfg.vq.ema_update:
        vq_state.pop("embed_target", None)
    vq = _load(VectorQuantize(cfg.vq), params_np["vq"], vq_state)
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
    """(params, state) of ``module`` as nested numpy trees, copies: on the
    CPU ``.numpy()`` would share the live tensors' memory, and a snapshot
    would follow the training that continues after it."""
    param_names = {n for n, _ in module.named_parameters()}
    sd = {k: v.detach().cpu().numpy().copy()
          for k, v in module.state_dict().items()}
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


def pretrain_from_jax(params_np: dict, teacher_np: dict, state_np: dict,
                      cfg):
    """``(PretrainModel, teacher Encoder)`` on the CPU from the trees of the
    JAX ``pretrain_init`` (``params``, ``teacher_params``, ``state`` with
    ``encoder``, ``vq`` and ``sem_encoder``); ``cfg`` is a
    PretrainConfig.  The teacher takes no gradients."""
    model, teacher = PretrainModel(cfg), Encoder(cfg.encoder)
    load_pretrain_trees(model, teacher, params_np, teacher_np, state_np)
    for p in teacher.parameters():
        p.requires_grad_(False)
    return model, teacher


def load_pretrain_trees(model: PretrainModel, teacher: Encoder,
                        params_np: dict, teacher_np: dict, state_np: dict):
    """Copy the JAX-form trees of :func:`pretrain_to_jax` into existing
    modules, in place (each tensor keeps its device)."""
    _load(model, params_np, {"encoder": state_np["encoder"],
                             "vq": state_np["vq"]})
    _load(teacher, teacher_np, state_np["sem_encoder"])


def pretrain_to_jax(model: PretrainModel, teacher: Encoder):
    """The reverse direction: ``(params, teacher_params, state)`` as nested
    numpy trees in the JAX package's form."""
    params, state = _module_trees(model)
    teacher_params, teacher_state = _module_trees(teacher)
    state["sem_encoder"] = teacher_state
    return params, teacher_params, state


LANGUAGE_MODELS = {DistilBertConfig: DistilBertModel, BertConfig: BertModel,
                   LlamaConfig: LlamaModel}


def language_model_from_jax(params_np: dict, cfg, device=None):
    """The port's DistilBERT, BERT or Llama (picked by the type of ``cfg``,
    the JAX package's config of the same name and fields) on ``device``
    from the JAX ``*_init`` / ``import_hf_*`` pytree as numpy arrays."""
    model = LANGUAGE_MODELS[type(cfg)](cfg, device="meta")
    return load_into(model, {k: torch.from_numpy(np.array(v, np.float32))
                             for k, v in _flat_names(params_np).items()},
                     device)


def _stack_args(params: dict) -> dict:
    """GNNStack's constructor arguments, read off a JAX stack tree: the
    conv kind from its keys (``mlp``: gine, ``att``: rgat, else rgcn), the
    width, relations and heads from its shapes."""
    conv = params["convs"][0]
    args = {"num_layers": len(params["convs"]),
            "batch_norm": bool(params["norms"]),
            "virtual_node": "vn_embed" in params}
    if "mlp" in conv:
        return dict(args, kind="gine",
                    dim=np.shape(conv["mlp"]["layers"][0]["w"])[0])
    num_rel, dim = np.shape(conv["weight"])[:2]
    if "att" in conv:
        return dict(args, kind="rgat", dim=dim, num_relations=num_rel,
                    heads=np.shape(conv["att"])[1])
    return dict(args, kind="rgcn", dim=dim, num_relations=num_rel)


def _mlp_dims(params: dict) -> list:
    layers = params["layers"]
    return [np.shape(layers[0]["w"])[0]] + [np.shape(p["w"])[1]
                                            for p in layers]


def gnn_stack_from_jax(params: dict, state: dict) -> GNNStack:
    """A :class:`GNNStack` on the CPU from JAX's ``gnn_stack_init`` trees
    (every kind; BatchNorm statistics; the virtual node and its MLP)."""
    return _load(GNNStack(**_stack_args(params)), params, state)


def mlp_from_jax(params: dict, state: dict) -> MLP:
    return _load(MLP(_mlp_dims(params), batch_norm=bool(params["norms"])),
                 params, state)


def attention_pool_from_jax(params: dict) -> AttentionPool:
    return _load(AttentionPool(np.shape(params["proj"]["w"])[0]), params,
                 {})


def predictor_from_jax(params: dict, state: dict) -> Predictor:
    """A :class:`~stemgnn_tpu_torch.zoo.predictors.Predictor` from JAX's
    ``graph_predictor_init`` trees ``{"encoder", "head"}``."""
    a = _stack_args(params["encoder"])
    model = Predictor(a["kind"], a["num_layers"], a["dim"],
                      _mlp_dims(params["head"])[-1],
                      num_relations=a.get("num_relations", 1),
                      virtual_node=a["virtual_node"])
    return _load(model, params, state)


def bin_graph_from_jax(params: dict, state: dict) -> BinGraphHead:
    """A :class:`~stemgnn_tpu_torch.ofa.heads.BinGraphHead` from JAX's
    ``bin_graph_init`` trees (attention pooling and RWPE as present)."""
    a = _stack_args(params["enc"])
    in_dim, out_dim = np.shape(params["in_proj"]["w"])
    walk = np.shape(params["edge_rwpe_prior"])[1] \
        if "edge_rwpe_prior" in params else None
    head = BinGraphHead(a["kind"], a["num_layers"], in_dim, out_dim,
                        task_dim=_mlp_dims(params["mlp"])[-1],
                        num_relations=a.get("num_relations", 1),
                        att_pool="att" in params, walk_length=walk)
    return _load(head, params, state)


def ofa_model_from_jax(params: dict, state: dict) -> OFAModel:
    """``ofa_train_eval``'s model from its JAX trees ``{"enc", "head"}``."""
    a = _stack_args(params["enc"])
    return _load(OFAModel(a["kind"], a["num_layers"], a["dim"]), params,
                 state)


def gnn_stack_to_jax(stack: GNNStack):
    """``(params, state)`` of a stack as nested numpy trees in JAX's form
    (empty lists, which hold no leaf, left out)."""
    return _module_trees(stack)


def bin_graph_to_jax(head: BinGraphHead):
    """``(params, state)`` of a bin-graph head in JAX's form."""
    return _module_trees(head)
