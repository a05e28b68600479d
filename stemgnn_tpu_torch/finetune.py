"""Finetune CLI of the port (counterpart of the repo's ``finetune.py``, its
node branch with ``--batch_size 0``).

Loads a pretrain checkpoint (``<path>/encoder_<epoch>.npz`` and
``vq_<epoch>.npz`` in the JAX package's format, with the architecture from
``config.json`` beside them when present), finetunes a task decoder on a
node dataset's full graph with the VQ frozen, and prints each epoch's loss
and train/val/test accuracy and the final mean and std over the splits.

Runs on CUDA (hub-dense matmuls + the aggregation kernels, forward and
backward) unless ``--device cpu`` is given; without CUDA and without
``--device cpu`` it exits with an error.  Flag values outside this slice
(link or graph tasks, minibatches, MoE, chunked eval, model export, no VQ
or an unfrozen VQ, ...) are refused with an error.

  python -m stemgnn_tpu_torch.finetune --finetune_dataset arxiv_synthetic_pl \\
      --pretrain_path ckpts/pretrain_model/default --epochs 3 --repeat 1
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys

from stemgnn_tpu_torch.core.config import (EncoderConfig, FinetuneConfig,
                                           VQConfig)
from stemgnn_tpu_torch.core.device import resolve_device
from stemgnn_tpu_torch.data.registry import dataset2task, load_dataset
from stemgnn_tpu_torch.train.finetune_loop import run_finetune
from stemgnn_tpu_torch.utils import checkpoint as ckpt
from stemgnn_tpu_torch.utils.convert import from_jax_pytree

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def get_args():
    """``finetune.py``'s flags and defaults, as far as this slice reads
    them."""
    p = argparse.ArgumentParser("Finetune")
    p.add_argument("--pretrain_dataset", "--pt_data", default="na")
    p.add_argument("--pretrain_model_epoch", "--pt_epochs", type=int,
                   default=25)
    p.add_argument("--pretrain_run_id", "--pt_run_id", default="")
    p.add_argument("--pretrain_path", default="")
    p.add_argument("--feat_dim", "--input_dim", type=int, default=768)
    p.add_argument("--hidden_dim", type=int, default=768)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--activation", "--act", default="relu")
    p.add_argument("--backbone", default="sage")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--normalize", default="batch")
    p.add_argument("--dropout", type=float, default=0.15)
    p.add_argument("--code_dim", type=int, default=768)
    p.add_argument("--codebook_size", type=int, default=128)
    p.add_argument("--codebook_head", type=int, default=4)
    p.add_argument("--codebook_decay", type=float, default=0.8)
    p.add_argument("--commit_weight", type=float, default=0.25)
    p.add_argument("--ortho_reg_weight", type=float, default=1)
    p.add_argument("--ortho_reg_max_codes", type=int, default=32)
    p.add_argument("--use_vq", type=int, default=1, choices=[0, 1])
    p.add_argument("--moe", action="store_true")
    p.add_argument("--lamda_env", type=float, default=0.0)
    p.add_argument("--finetune_dataset", "--dataset", "--data",
                   default="cora_synthetic")
    p.add_argument("--freeze_vq", type=int, default=1, choices=[0, 1])
    p.add_argument("--repeat", type=int, default=10)
    p.add_argument("--finetune_epochs", "--epochs", type=int, default=1000)
    p.add_argument("--early_stop", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=0)
    p.add_argument("--finetune_lr", "--lr", type=float, default=1e-3)
    p.add_argument("--finetune_seed", type=int, default=None)
    p.add_argument("--separate_decoder_for_each_head", type=int, default=1)
    p.add_argument("--decoder_jac_coeff", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--text_encoder", default="hash")
    p.add_argument("--save_model", default="")
    p.add_argument("--eval_chunked", type=int, default=0, choices=[0, 1])
    p.add_argument("--use_fused_layout", type=int, default=1, choices=[0, 1])
    p.add_argument("--hub_size", type=int, default=2048)
    p.add_argument("--reorder", default="auto",
                   choices=["auto", "off", "rcm", "degree", "community"])
    p.add_argument("--halo_shards", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def refusals(args) -> list:
    """What this slice does not cover among the given flag values."""
    task = dataset2task.get(args.finetune_dataset)
    checks = (
        (task is not None and task != "node",
         f"{args.finetune_dataset!r} is a {task} task; the port finetunes "
         f"node tasks so far"),
        (args.batch_size > 0, "--batch_size > 0: minibatch training is not "
                              "ported; use --batch_size 0 (full batch)"),
        (args.moe, "--moe: MoE-SAGE layers are not ported"),
        (args.eval_chunked, "--eval_chunked 1: the layer-wise chunked eval "
                            "is not ported"),
        (bool(args.save_model), "--save_model: the task-model export is not "
                                "ported"),
        (args.use_vq == 0, "--use_vq 0: only the VQ path is ported"),
        (args.freeze_vq == 0, "--freeze_vq 0: VQ training (EMA, orthogonal "
                              "loss) is not ported; the VQ stays frozen"),
        (args.bf16, "--bf16: bf16 compute is not ported"),
        (args.backbone != "sage", f"--backbone {args.backbone}: only sage "
                                  f"is ported"),
        (args.halo_shards > 0, "--halo_shards: multi-GPU finetune is not "
                               "ported"),
        (args.reorder in ("rcm", "degree", "community"),
         f"--reorder {args.reorder}: node relabelling (ops/reorder.py) is "
         f"not ported; use auto or off"),
    )
    return [msg for bad, msg in checks if bad]


def _pretrained(args):
    """The pretrained encoder and VQ modules, or None without a path;
    ``args`` adopts the architecture saved beside the checkpoint."""
    path = args.pretrain_path
    if not path and args.pretrain_dataset != "na":
        path = osp.join(ROOT, "ckpts", "pretrain_model",
                        args.pretrain_run_id or "default")
    if not path:
        return None, None
    ep = args.pretrain_model_epoch
    enc_p = osp.join(path, f"encoder_{ep}.npz")
    if not osp.exists(enc_p):
        raise FileNotFoundError(f"Cannot find encoder checkpoint {enc_p}. "
                                "Set --pretrain_path to a valid folder.")
    cfg_json = osp.join(path, "config.json")
    if osp.exists(cfg_json):
        with open(cfg_json) as f:
            saved = json.load(f)
        for k_src, k_dst in (("hidden_dim", "hidden_dim"),
                             ("num_layers", "num_layers"),
                             ("backbone", "backbone"), ("moe", "moe")):
            if k_src in saved.get("encoder", {}):
                setattr(args, k_dst, saved["encoder"][k_src])
        for k_src, k_dst in (("codebook_size", "codebook_size"),
                             ("codebook_dim", "code_dim"),
                             ("heads", "codebook_head")):
            if k_src in saved.get("vq", {}):
                setattr(args, k_dst, saved["vq"][k_src])
        print("Adopted architecture hyperparams from config.json")
    return ckpt.load_pytree(enc_p), ckpt.load_pytree(
        osp.join(path, f"vq_{ep}.npz"))


def make_config(args, num_classes: int) -> FinetuneConfig:
    return FinetuneConfig(
        encoder=EncoderConfig(
            input_dim=args.feat_dim, hidden_dim=args.hidden_dim,
            num_layers=args.num_layers, backbone=args.backbone,
            normalize=args.normalize, dropout=args.dropout,
            activation=args.activation),
        vq=VQConfig(
            dim=args.hidden_dim, codebook_size=args.codebook_size,
            codebook_dim=args.code_dim, heads=args.codebook_head,
            decay=args.codebook_decay, commitment_weight=args.commit_weight,
            orthogonal_reg_weight=args.ortho_reg_weight,
            orthogonal_reg_max_codes=args.ortho_reg_max_codes,
            kmeans_init=True),
        dataset=args.finetune_dataset, task="node",
        epochs=args.finetune_epochs, early_stop=args.early_stop,
        batch_size=args.batch_size, lr=args.finetune_lr,
        repeat=1 if args.finetune_seed is not None else args.repeat,
        use_vq=bool(args.use_vq), freeze_vq=bool(args.freeze_vq),
        separate_decoder_for_each_head=bool(
            args.separate_decoder_for_each_head),
        decoder_jac_coeff=args.decoder_jac_coeff, lamda_env=args.lamda_env,
        num_classes=num_classes, eval_chunked=bool(args.eval_chunked),
        use_fused_layout=bool(args.use_fused_layout), hub_size=args.hub_size,
        reorder=args.reorder)


def main(argv=None):
    """Run the CLI.  Returns ``run_finetune``'s dict (the Logger and the
    last split's model, graph and step functions) for callers that go on
    working with them, as ``chip_smoke.py`` does."""
    args = get_args().parse_args(argv)
    bad = refusals(args)
    if bad:
        raise SystemExit("stemgnn_tpu_torch.finetune: " + "; ".join(bad))
    try:
        device = resolve_device(args.device)
    except RuntimeError as ex:
        raise SystemExit(f"stemgnn_tpu_torch.finetune: {ex}") from ex
    name = args.finetune_dataset
    if name not in dataset2task:
        raise KeyError(f"Unknown dataset {name}")

    ds = load_dataset(name, feat_dim=args.feat_dim, seed=args.seed,
                      text_encoder=args.text_encoder)
    enc, vq = _pretrained(args)
    bad = refusals(args)          # config.json may name another backbone
    if bad:
        raise SystemExit("stemgnn_tpu_torch.finetune: " + "; ".join(bad))
    cfg = make_config(args, ds.num_classes)
    pretrained = None
    if enc is not None:
        encoder, quantizer = from_jax_pytree(
            {"encoder": enc["params"], "vq": vq["params"]},
            {"encoder": enc["state"], "vq": vq["state"]}, cfg)
        pretrained = {"encoder": encoder, "vq": quantizer}
        print("Loaded pretrained encoder and VQ.")
    res = run_finetune(ds, cfg, pretrained=pretrained, device=device,
                       verbose=True)
    best = res["logger"].get_best()
    for k, label in (("train", "train:"), ("val", "val:  "),
                     ("test", "test: ")):
        print("final/{} {:.2f} ± {:.2f}".format(label, best[k]["mean"],
                                                best[k]["std"]))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
