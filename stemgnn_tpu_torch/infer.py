"""Batch inference / export CLI of the port (counterpart of the repo's
``infer.py``).

``--mode encode`` (the default) loads a pretrain checkpoint
(``<path>/encoder_<epoch>.npz`` and ``vq_<epoch>.npz``, with the
architecture from ``config.json`` beside them when present, as ``python -m
stemgnn_tpu_torch.pretrain`` writes them), encodes a node or link
dataset's full graph (a link dataset's typed edges through the type table,
as JAX's ``infer.py`` encodes WN18RR) and writes per-node ``embeddings``
[N, D], ``quantized`` embeddings [N, D] and VQ ``codes`` [N, H] into one
npz; for a graph dataset the per-molecule mean-pooled analogs [G, D] /
[G, H].

``--mode predict`` loads a task model that ``finetune --save_model`` wrote
(either package's: the same trees and meta) and writes the class
probabilities ``probs`` [items, C] and their argmax ``pred`` for every node
of a node dataset or every edge of a link dataset (the midpoints of its
endpoints' embeddings); for a graph dataset the per-molecule multitask
probabilities ``probs`` [G, T] (the sigmoid of the head-mean ``logits``,
also written) and ``pred = probs > 0.5``.

Runs on CUDA (hub-dense matmuls + the aggregation kernels) unless
``--device cpu`` is given; without CUDA and without ``--device cpu`` it
exits with an error.

  python -m stemgnn_tpu_torch.infer --finetune_dataset arxiv_synthetic_pl \\
      --pretrain_path ckpts/pretrain_model/default --out codes.npz
  python -m stemgnn_tpu_torch.infer --mode predict --finetune_dataset \\
      FB15K237 --model fb.npz --out preds.npz
  python -m stemgnn_tpu_torch.infer --mode predict --finetune_dataset \\
      smiles:mols.csv --model mols.npz --out mol_probs.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as osp
import sys

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import (EncoderConfig, FinetuneConfig,
                                           VQConfig, from_dict)
from stemgnn_tpu_torch.core.device import resolve_device
from stemgnn_tpu_torch.data.registry import (check_feature_width,
                                             dataset2task, load_dataset)
from stemgnn_tpu_torch.train.finetune_loop import (graph_task_encode,
                                                   graph_task_predict)
from stemgnn_tpu_torch.train.graph_setup import (describe_layout,
                                                 fused_full_graph)
from stemgnn_tpu_torch.utils import checkpoint as ckpt
from stemgnn_tpu_torch.models.task import encode, task_logits
from stemgnn_tpu_torch.utils.convert import (from_jax_pytree,
                                             task_model_from_jax)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def get_args():
    p = argparse.ArgumentParser("Infer")
    p.add_argument("--mode", default="encode", choices=["encode", "predict"])
    p.add_argument("--finetune_dataset", "--dataset", "--data",
                   default="cora_synthetic")
    p.add_argument("--feat_dim", type=int, default=768)
    p.add_argument("--text_encoder", default="hash")
    p.add_argument("--pretrain_run_id", default="")
    p.add_argument("--pretrain_path", default="",
                   help="directory of encoder_<epoch>.npz / vq_<epoch>.npz, "
                        "as python -m stemgnn_tpu_torch.pretrain writes "
                        "them (default: ckpts/pretrain_model/<run_id>)")
    p.add_argument("--pretrain_model_epoch", type=int, default=50)
    p.add_argument("--model", default="",
                   help="task-model npz from finetune --save_model "
                        "(mode=predict)")
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
    task = dataset2task.get(name)
    if task is None:
        raise KeyError(f"Unknown dataset {name}")
    if args.mode == "predict":
        return predict(args, task, device)
    ds = load_dataset(name, feat_dim=args.feat_dim, seed=args.seed,
                      text_encoder=args.text_encoder, device=device)

    path = args.pretrain_path or osp.join(
        ROOT, "ckpts", "pretrain_model", args.pretrain_run_id or "default")
    ep = args.pretrain_model_epoch
    enc = ckpt.load_pytree(osp.join(path, f"encoder_{ep}.npz"))
    vq = ckpt.load_pytree(osp.join(path, f"vq_{ep}.npz"))
    cfg = dataclasses.replace(encode_config(args, path), task=task)
    check_feature_width(ds, cfg.encoder.input_dim, args.text_encoder)
    encoder, quantizer = from_jax_pytree(
        {"encoder": enc["params"], "vq": vq["params"]},
        {"encoder": enc["state"], "vq": vq["state"]}, cfg)
    encoder, quantizer = encoder.to(device), quantizer.to(device)
    if task == "graph":
        # per-molecule pooled embeddings and VQ codes
        pooled, quant, codes = graph_task_encode(ds[0], cfg, encoder,
                                                 quantizer)
        np.savez_compressed(args.out, embeddings=pooled, quantized=quant,
                            codes=codes)
        print(f"wrote {args.out}: embeddings {pooled.shape}, codes "
              f"{codes.shape} (per-molecule)", flush=True)
        return {"embeddings": pooled, "quantized": quant, "codes": codes,
                "encoder": encoder, "quantizer": quantizer}

    # a link dataset's typed edges: the type table rides the layout
    graph = fused_full_graph(ds, cfg, device=device)
    if graph.layout is not None:
        t_rows = (1 if graph.edge_table is None
                  else int(graph.edge_table.shape[0]))
        print(describe_layout(graph.layout, t_rows), flush=True)
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


def predict(args, task: str, device):
    """``--mode predict`` (JAX infer.py:69-110): the saved task model's
    head-mean softmax probabilities over the fused full graph, or a graph
    task's per-molecule sigmoid probabilities."""
    if not args.model:
        raise SystemExit("--mode predict needs --model (a task-model npz "
                         "from finetune --save_model)")
    payload = ckpt.load_pytree(args.model)
    meta = ckpt.load_meta(args.model) or {}
    cfg = from_dict(FinetuneConfig(), meta["config"])
    model = task_model_from_jax(payload["params"], payload["state"],
                                cfg).to(device).eval()
    ds = load_dataset(args.finetune_dataset, feat_dim=args.feat_dim,
                      seed=args.seed, text_encoder=args.text_encoder,
                      device=device)
    check_feature_width(ds, cfg.encoder.input_dim, args.text_encoder)
    if task == "graph":
        # per-molecule multitask probabilities (JAX infer.py:85-99)
        graphs, labels, _ = ds
        logits = graph_task_predict(graphs, labels.shape[1], cfg, model)
        probs = 1.0 / (1.0 + np.exp(-logits))
        np.savez_compressed(args.out, probs=probs, logits=logits,
                            pred=(probs > 0.5).astype(np.int8))
        print(f"wrote {args.out}: probs {probs.shape} (per-molecule "
              f"multitask)", flush=True)
        return {"probs": probs, "logits": logits, "model": model,
                "cfg": cfg}
    # a link dataset's typed edges: the type table rides the layout
    graph = fused_full_graph(ds, cfg, device=device)
    if graph.layout is not None:
        t_rows = (1 if graph.edge_table is None
                  else int(graph.edge_table.shape[0]))
        print(describe_layout(graph.layout, t_rows), flush=True)
    with torch.no_grad():
        z = encode(model, graph)
        if task == "link":
            z = (z[graph.senders] + z[graph.receivers]) / 2.0
            row_mask, n_items = graph.edge_mask, ds.num_edges
        else:
            row_mask, n_items = graph.node_mask, ds.num_nodes
        logits, _ = task_logits(model, cfg, z, mask=row_mask)
        probs = torch.softmax(logits.mean(1), dim=-1)[:n_items]
    probs = probs.cpu().numpy()
    np.savez_compressed(args.out, probs=probs, pred=probs.argmax(-1))
    print(f"wrote {args.out}: probs {probs.shape}", flush=True)
    return {"probs": probs, "graph": graph, "model": model, "cfg": cfg}


if __name__ == "__main__":
    main(sys.argv[1:])
