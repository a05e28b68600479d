"""The reference's checkpoint importer (counterpart of
``stemgnn_tpu/utils/torch_import.py``).

Reads the reference's PyTorch ``state_dict`` layouts (STEM-GNN/pretrain.py:
160-165 saves ``encoder_{i}.pt`` / ``vq_{i}.pt``) into the port's modules,
so a model trained with the reference finetunes, serves or evaluates here.
The translation is the JAX package's:

  * ``nn.Linear.weight`` is [out, in]; the port's ``Linear.w`` is [in, out]
    (transposed), and so is PyG's Linear inside MySAGEConv;
  * BatchNorm's running statistics become the buffers ``mean`` / ``var`` /
    ``count``;
  * the VQ's ``_codebook.embed`` [H, C, d], ``embed_avg``, ``cluster_size``
    and ``initted`` become the codebook parameter and its buffers.

The sage, MoE-SAGE, gin and gcn layers are read; a gat layer raises, as in
JAX.  Accepts a ``.pt`` file or a mapping of arrays keyed by ``state_dict``
names.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import EncoderConfig, PretrainConfig
from stemgnn_tpu_torch.models.pretrain import PretrainModel
from stemgnn_tpu_torch.nn.encoder import Encoder
from stemgnn_tpu_torch.nn.layers import Linear
from stemgnn_tpu_torch.vq.quantize import VectorQuantize


def load_state_dict(path_or_dict) -> Dict[str, np.ndarray]:
    """A mapping of numpy arrays: the given mapping's values, or the
    ``.pt`` file's ``state_dict`` (a module's when the file holds one)."""
    if isinstance(path_or_dict, Mapping):
        return {k: np.asarray(v) for k, v in path_or_dict.items()}
    sd = torch.load(path_or_dict, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _lin(sd, prefix, bias=True):
    p = {"w": sd[prefix + ".weight"].T}
    if bias and prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _load(module, flat: dict):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in flat.items()}, strict=True)
    return module


def _flat(tree, prefix=""):
    """Nested dicts and lists -> {dotted name: array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def encoder_trees(sd: Dict[str, np.ndarray], cfg: EncoderConfig):
    """``(params, state)`` of one encoder in the JAX package's tree form
    (``layers``, ``norms``, ``env_encoders``; the norms' statistics)."""
    flags = cfg.moe_layer_flags()
    layers, norms_p, norms_s, env = [], [], [], []
    for i in range(cfg.num_layers):
        if flags[i] and cfg.backbone == "sage":
            layers.append({"weights": sd[f"layers.{i}.weights"]})
            env.append(_lin(sd, f"env_encoders.{len(env)}"))
        elif cfg.backbone == "sage":
            layers.append({"lin_l": _lin(sd, f"layers.{i}.lin_l"),
                           "lin_r": _lin(sd, f"layers.{i}.lin_r",
                                         bias=False)})
        elif cfg.backbone == "gin":
            # PyG keeps a fixed eps as a [1] buffer; the port's is 0-dim
            eps = np.asarray(sd.get(f"layers.{i}.eps", 0.0), np.float32)
            layers.append({"lin": _lin(sd, f"layers.{i}.nn"),
                           "eps": eps.reshape(())})
        elif cfg.backbone == "gcn":
            layers.append({"lin": _lin(sd, f"layers.{i}.lin", bias=False),
                           "bias": sd[f"layers.{i}.bias"]})
        else:
            raise NotImplementedError(
                f"import for backbone {cfg.backbone} layer {i}")
        norms_p.append({"scale": sd[f"norms.{i}.weight"],
                        "bias": sd[f"norms.{i}.bias"]})
        norms_s.append({
            "mean": sd[f"norms.{i}.running_mean"],
            "var": sd[f"norms.{i}.running_var"],
            "count": np.asarray(sd.get(f"norms.{i}.num_batches_tracked", 0),
                                np.int32)})
    return ({"layers": layers, "norms": norms_p, "env_encoders": env},
            {"norms": norms_s})


def import_encoder(path_or_dict, cfg: EncoderConfig) -> Encoder:
    """An :class:`~stemgnn_tpu_torch.nn.encoder.Encoder` (CPU, eval mode)
    holding the reference encoder's weights and statistics."""
    params, state = encoder_trees(load_state_dict(path_or_dict), cfg)
    return _load(Encoder(cfg), {**_flat(params), **_flat(state)}).eval()


def vq_trees(sd: Dict[str, np.ndarray]):
    """``(params, state)`` of the VQ in the JAX package's tree form."""
    params = {}
    if "project_in.weight" in sd:
        params["project_in"] = _lin(sd, "project_in")
        params["project_out"] = _lin(sd, "project_out")
    embed = sd["_codebook.embed"]
    params["embed"] = embed
    state = {
        "embed_avg": sd.get("_codebook.embed_avg", embed),
        "cluster_size": sd.get("_codebook.cluster_size",
                               np.zeros(embed.shape[:2], np.float32)),
        "initted": np.asarray(bool(np.asarray(
            sd.get("_codebook.initted", [True])).reshape(-1)[0]))}
    return params, state


def import_vq(path_or_dict, cfg) -> VectorQuantize:
    """A :class:`~stemgnn_tpu_torch.vq.quantize.VectorQuantize` (CPU, eval
    mode) with the reference codebook (``cfg`` a VQConfig)."""
    params, state = vq_trees(load_state_dict(path_or_dict))
    return _load(VectorQuantize(cfg), {**_flat(params),
                                       **_flat(state)}).eval()


def import_task_decoder(path_or_dict) -> Linear:
    """The finetune model's ``decoder`` Linear."""
    p = _lin(load_state_dict(path_or_dict), "decoder")
    lin = Linear(p["w"].shape[0], p["w"].shape[1], bias="b" in p)
    return _load(lin, p)


def import_pretrain_model(path_or_dict, cfg: PretrainConfig):
    """``(PretrainModel, teacher Encoder)`` on the CPU from a whole
    reference ``PretrainModel`` state_dict (pt_model.py:11-23): the
    student's encoder and VQ, the four heads and the ``sem_encoder``
    teacher, which takes no gradients."""
    sd = load_state_dict(path_or_dict)

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}
    enc_p, enc_s = encoder_trees(sub("encoder."), cfg.encoder)
    vq_p, vq_s = vq_trees(sub("vq."))
    t_p, t_s = encoder_trees(sub("sem_encoder."), cfg.encoder)
    params = {"encoder": enc_p, "vq": vq_p,
              "feat_dec": _lin(sd, "feat_recon_decoder"),
              "topo_dec": {"lin": _lin(sd, "topo_recon_decoder.lin")},
              "topo_sem_dec": _lin(sd, "topo_sem_recon_decoder"),
              "sem_projector": _lin(sd, "sem_projector")}
    model = _load(PretrainModel(cfg), {
        **_flat(params), **_flat({"encoder": enc_s, "vq": vq_s})})
    teacher = _load(Encoder(cfg.encoder), {**_flat(t_p), **_flat(t_s)})
    for p in teacher.parameters():
        p.requires_grad_(False)
    return model, teacher
