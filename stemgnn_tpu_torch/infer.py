"""Batch inference / export CLI of the port (counterpart of the repo's
``infer.py``).

``--mode encode`` (the default and, so far, the only mode) loads a pretrain
checkpoint (``<path>/encoder_<epoch>.npz`` and ``vq_<epoch>.npz``, with the
architecture from ``config.json`` beside them when present), encodes a node
dataset's full graph and writes per-node ``embeddings`` [N, D],
``quantized`` embeddings [N, D] and VQ ``codes`` [N, H] into one npz.

Runs on CUDA (hub-dense matmuls + the ``scatter_rows_sorted`` kernel) unless
``--device cpu`` is given; without CUDA and without ``--device cpu`` it
exits with an error.

  python -m stemgnn_tpu_torch.infer --finetune_dataset arxiv_synthetic_pl \\
      --pretrain_path ckpts/pretrain_model/default --out codes.npz
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import (EncoderConfig, FinetuneConfig,
                                           VQConfig)
from stemgnn_tpu_torch.core.device import resolve_device
from stemgnn_tpu_torch.data.registry import dataset2task, load_dataset
from stemgnn_tpu_torch.train.graph_setup import (describe_layout,
                                                 fused_full_graph)
from stemgnn_tpu_torch.utils import checkpoint as ckpt
from stemgnn_tpu_torch.utils.convert import from_jax_pytree

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def get_args():
    p = argparse.ArgumentParser("Infer")
    p.add_argument("--mode", default="encode", choices=["encode", "predict"])
    p.add_argument("--finetune_dataset", "--dataset", "--data",
                   default="cora_synthetic")
    p.add_argument("--feat_dim", type=int, default=768)
    p.add_argument("--text_encoder", default="hash")
    p.add_argument("--pretrain_run_id", default="")
    p.add_argument("--pretrain_path", default="")
    p.add_argument("--pretrain_model_epoch", type=int, default=50)
    p.add_argument("--model", default="",
                   help="task-model npz (mode=predict, not ported yet)")
    p.add_argument("--out", default="inference_out.npz")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p


def encode_config(args, path: str):
    """The FinetuneConfig of ``infer.py --mode encode``: 768-wide defaults,
    overridden by ``config.json`` beside the checkpoint."""
    enc_kw = dict(input_dim=args.feat_dim, hidden_dim=args.feat_dim,
                  num_layers=2, normalize="batch", dropout=0.0)
    vq_kw = dict(dim=args.feat_dim, codebook_size=128,
                 codebook_dim=args.feat_dim, heads=4)
    cfg_json = osp.join(path, "config.json")
    if osp.exists(cfg_json):
        with open(cfg_json) as f:
            saved = json.load(f)
        for k in ("hidden_dim", "num_layers", "backbone", "normalize"):
            if k in saved.get("encoder", {}):
                enc_kw[k] = saved["encoder"][k]
        for k in ("codebook_size", "codebook_dim", "heads"):
            if k in saved.get("vq", {}):
                vq_kw[k] = saved["vq"][k]
    return FinetuneConfig(encoder=EncoderConfig(**enc_kw),
                          vq=VQConfig(**vq_kw),
                          dataset=args.finetune_dataset, task="node")


def main(argv=None):
    """Run the CLI.  Returns the encode's tensors and objects (``z``,
    ``vq`` outputs, ``graph``, ``encoder``, ``quantizer``) for callers that
    go on working with them, as ``chip_smoke.py`` does."""
    args = get_args().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as ex:
        raise SystemExit(f"stemgnn_tpu_torch.infer: {ex}") from ex

    name = args.finetune_dataset
    if args.mode == "predict":
        raise NotImplementedError("--mode predict is not ported yet")
    task = dataset2task.get(name)
    if task is None:
        raise KeyError(f"Unknown dataset {name}")
    if task != "node":
        raise NotImplementedError(f"{name!r} is a {task} task; the port "
                                  f"encodes node datasets so far")
    ds = load_dataset(name, feat_dim=args.feat_dim, seed=args.seed,
                      text_encoder=args.text_encoder)

    path = args.pretrain_path or osp.join(
        ROOT, "ckpts", "pretrain_model", args.pretrain_run_id or "default")
    ep = args.pretrain_model_epoch
    enc = ckpt.load_pytree(osp.join(path, f"encoder_{ep}.npz"))
    vq = ckpt.load_pytree(osp.join(path, f"vq_{ep}.npz"))
    cfg = encode_config(args, path)
    encoder, quantizer = from_jax_pytree(
        {"encoder": enc["params"], "vq": vq["params"]},
        {"encoder": enc["state"], "vq": vq["state"]}, cfg)
    encoder, quantizer = encoder.to(device), quantizer.to(device)

    graph = fused_full_graph(ds, cfg, device=device)
    if graph.layout is not None:
        print(describe_layout(graph.layout), flush=True)
    with torch.no_grad():
        z = encoder(graph.node_feat, graph.senders, graph.receivers,
                    edge_feat=graph.edge_feat, edge_mask=graph.edge_mask,
                    layout=graph.layout, edge_table=graph.edge_table)
        res = quantizer(z)
    n = ds.num_nodes
    np.savez(args.out,
             embeddings=z[:n].cpu().numpy(),
             quantized=res["quantize"][:n].cpu().numpy(),
             codes=res["indices"][:n].cpu().numpy())
    print(f"wrote {args.out}: embeddings [{n}, {z.shape[1]}], codes "
          f"[{n}, {res['indices'].shape[-1]}]", flush=True)
    return {"z": z, "vq": res, "graph": graph, "encoder": encoder,
            "quantizer": quantizer, "num_nodes": n}


if __name__ == "__main__":
    main(sys.argv[1:])
