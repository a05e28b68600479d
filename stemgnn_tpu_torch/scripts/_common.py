"""Command-line plumbing shared by the robustness evaluation scripts
(counterpart of the repo's ``scripts/_common.py``): the same flags and
aliases, plus ``--device``.

Every backbone and ``--moe`` with ``--lamda_env`` run as in JAX.  The node
datasets of files (``cora``, ``pubmed``, ``arxiv``, ``wikics``) load from
their cache or raw files, and the neural text encoders run on ``--device``
(``data/text_encoder.py``).  ``--use_vq 0`` (the no-VQ bypass) and
``--freeze_vq 0`` (the codebook trained with the rest) run as in JAX.  Link
and graph datasets are refused as in the JAX scripts, which classify nodes
only.
"""

from __future__ import annotations

import argparse
import json
import os

from stemgnn_tpu_torch.core import config as cfglib
from stemgnn_tpu_torch.core.device import resolve_device
from stemgnn_tpu_torch.data.registry import (check_feature_width,
                                             dataset2task, load_dataset)
from stemgnn_tpu_torch.data.text_encoder import NEURAL
from stemgnn_tpu_torch.utils.observability import apply_wandb_sweep_config



def base_parser(name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(name)
    p.add_argument("--finetune_dataset", "--dataset", "--data",
                   default="cora_synthetic")
    p.add_argument("--feat_dim", type=int, default=768)
    p.add_argument("--text_encoder", default="hash",
                   choices=["hash", "tfidf", *NEURAL])
    p.add_argument("--hidden_dim", type=int, default=768)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--normalize", default="none")
    p.add_argument("--dropout", type=float, default=0.15)
    p.add_argument("--backbone", default="sage")
    p.add_argument("--code_dim", type=int, default=768)
    p.add_argument("--codebook_size", type=int, default=128)
    p.add_argument("--codebook_head", type=int, default=4)
    p.add_argument("--use_vq", type=int, default=1)
    p.add_argument("--freeze_vq", type=int, default=1)
    p.add_argument("--moe", action="store_true")
    p.add_argument("--moe_layers", default="none")
    p.add_argument("--moe_experts", "--K", type=int, default=3)
    p.add_argument("--moe_tau", "--tau", type=float, default=1.0)
    p.add_argument("--lamda_env", type=float, default=0.0)
    p.add_argument("--finetune_epochs", "--epochs", type=int, default=300)
    p.add_argument("--early_stop", type=int, default=100)
    p.add_argument("--finetune_lr", "--lr", type=float, default=5e-4)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pretrain_path", default="")
    p.add_argument("--pretrain_model_epoch", type=int, default=25)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--output_json", default="")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p


def refusals(args) -> list:
    """What the port does not cover among the given flag values."""
    name = args.finetune_dataset
    task = dataset2task.get(name)
    checks = (
        (task != "node", f"{name} is not a node-classification dataset; the "
                         f"robustness evaluations classify nodes"),
    )
    return [msg for bad, msg in checks if bad]


def build_cfg(args, num_classes: int) -> cfglib.FinetuneConfig:
    enc = cfglib.EncoderConfig(
        input_dim=args.feat_dim, hidden_dim=args.hidden_dim,
        num_layers=args.num_layers, backbone=args.backbone,
        normalize=args.normalize, dropout=args.dropout, moe=args.moe,
        num_experts=args.moe_experts, tau=args.moe_tau,
        moe_layers=args.moe_layers)
    vq = cfglib.VQConfig(
        dim=args.hidden_dim, codebook_size=args.codebook_size,
        codebook_dim=args.code_dim, heads=args.codebook_head,
        commitment_weight=0.25, kmeans_init=not bool(args.pretrain_path))
    return cfglib.FinetuneConfig(
        encoder=enc, vq=vq, dataset=args.finetune_dataset, task="node",
        epochs=args.finetune_epochs, early_stop=args.early_stop,
        lr=args.finetune_lr, use_vq=bool(args.use_vq),
        freeze_vq=bool(args.freeze_vq), lamda_env=args.lamda_env,
        num_classes=num_classes)


def load_node_dataset(args):
    ds = load_dataset(args.finetune_dataset, feat_dim=args.feat_dim,
                      seed=args.seed, text_encoder=args.text_encoder,
                      device=args.device)
    check_feature_width(ds, args.feat_dim, args.text_encoder)
    return ds


def load_pretrained(args):
    """The checkpoint's encoder and VQ trees (``encoder_<epoch>.npz`` and
    ``vq_<epoch>.npz`` under ``--pretrain_path``), or None without a
    path."""
    if not args.pretrain_path:
        return None
    from stemgnn_tpu_torch.train.pretrain_loop import (
        load_pretrained_for_finetune)
    enc = os.path.join(args.pretrain_path,
                       f"encoder_{args.pretrain_model_epoch}.npz")
    vq = os.path.join(args.pretrain_path,
                      f"vq_{args.pretrain_model_epoch}.npz")
    return load_pretrained_for_finetune(enc, vq)


def parse_with_sweep(parser: argparse.ArgumentParser,
                     project: str = "STEM-GNN-Finetune", argv=None):
    """``parse_args`` and the wandb sweep round-trip (offline or with
    ``--debug``: plain ``parse_args``), then the refusals and the device:
    ``args.device`` becomes a ``torch.device``, CUDA unless ``--device cpu``
    was given.  Exits non-zero, naming the script, on a refusal or when
    CUDA is asked for and absent."""
    args = parser.parse_args(argv)
    args = apply_wandb_sweep_config(args, project, debug=args.debug)
    bad = refusals(args)
    if bad:
        raise SystemExit(f"{parser.prog}: " + "; ".join(bad))
    try:
        args.device = resolve_device(args.device)
    except RuntimeError as ex:
        raise SystemExit(f"{parser.prog}: {ex}") from ex
    return args


def emit(payload: dict, args):
    print(json.dumps(payload, indent=2, default=float))
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(payload, f, default=float)
