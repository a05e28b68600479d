"""Finetune CLI of the port (counterpart of the repo's ``finetune.py``).

Loads a pretrain checkpoint (``<path>/encoder_<epoch>.npz`` and
``vq_<epoch>.npz`` in the JAX package's format, with the architecture from
``config.json`` beside them when present, as ``python -m
stemgnn_tpu_torch.pretrain`` writes them under
``ckpts/pretrain_model/<run_id>/``), finetunes a task decoder on a node
dataset (node classification) or a knowledge graph's edges (link task:
relation classification; ``kg_synthetic`` with typed edges, or the cached
``WN18RR`` and ``FB15K237``), full batch or on neighbour-sampled
minibatches (``--batch_size``), or a graph task on molecules
(``mol_synthetic``, or ``smiles:<csv>`` featurized without RDKit:
multitask binary labels, mean pooling, the per-task AUC; ``--eval_every``,
``--eval_batch_size``, ``--eval_train_auc``), and prints each epoch's loss
and train/val/test metric and the final mean and std over the splits.
``--bf16`` trains with a bf16 encoder (the VQ keeps its f32 config and
takes the bf16 ``z``, so its projections run in bf16; JAX finetune.py:231);
``--eval_bf16 1`` runs the graph task's evaluation forward with a bf16
encoder.  ``--use_params`` applies the dataset's preset of
``configs/finetune.yaml``
under the explicit flags, as the JAX CLI does: WN18RR trains full batch,
FB15K237 on batches of 1,024 edges, ``mol_synthetic`` on batches of 64
molecules.  ``--save_model`` writes the best task model for ``python -m
stemgnn_tpu_torch.infer --mode predict``; ``--eval_chunked 1`` evaluates
layer by layer over edge blocks.

Runs on CUDA (hub-dense matmuls + the aggregation kernels, forward and
backward) unless ``--device cpu`` is given; without CUDA and without
``--device cpu`` it exits with an error.  Every flag of the JAX CLI is
accepted; ``--moe`` (with ``--lamda_env``'s environment regularizer) and
``--backbone gcn|gin|gat`` train as in JAX; ``--donate`` (buffer
donation) is refused with an error naming its ROADMAP item.  ``cora``,
``pubmed``, ``arxiv`` and ``wikics`` load from their cache or raw files
(``data/raw_parsers.py``), and
``--text_encoder ST|e5|llama2_7b|llama2_13b`` encodes texts with a local
snapshot's language model on ``--device`` (``data/text_encoder.py``);
``--feat_dim`` must then be the model's width.  Without a checkpoint
the codebook is k-means-initialized before training.

``--halo_shards S`` (node task) trains the full graph over S ranks, each
owning a block of nodes and exchanging the boundary rows a layer
(``parallel/``): under torchrun (``RANK`` / ``WORLD_SIZE`` set) this
process is one rank, otherwise S ranks are spawned here (NCCL when each
has a card of its own, gloo when they share one or run on the CPU).
``--halo_balance`` / ``--halo_order none|balance|rcm|community`` relabel
the nodes first and ``--hub_size`` sizes the layouts' hub blocks, as in
JAX; ``--save_model``, ``--eval_chunked`` and ``--reorder`` are not read
there, as in JAX.

  python -m stemgnn_tpu_torch.finetune --finetune_dataset WN18RR --use_params
  python -m stemgnn_tpu_torch.finetune --finetune_dataset FB15K237 \\
      --use_params --save_model fb.npz
  python -m stemgnn_tpu_torch.finetune --finetune_dataset mol_synthetic \\
      --use_params --epochs 5 --repeat 1
  python -m stemgnn_tpu_torch.finetune --finetune_dataset arxiv_synthetic_pl \\
      --pretrain_path ckpts/pretrain_model/default --epochs 3 --repeat 1
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys

from stemgnn_tpu_torch.core import config as cfglib
from stemgnn_tpu_torch.core.config import (EncoderConfig, FinetuneConfig,
                                           VQConfig)
from stemgnn_tpu_torch.core.device import resolve_device
from stemgnn_tpu_torch.data.registry import (check_feature_width,
                                             dataset2task, load_dataset)
from stemgnn_tpu_torch.data.text_encoder import NEURAL
from stemgnn_tpu_torch.train.finetune_loop import run_finetune
from stemgnn_tpu_torch.utils import checkpoint as ckpt
from stemgnn_tpu_torch.utils.convert import from_jax_pytree
from stemgnn_tpu_torch.utils.observability import apply_wandb_sweep_config
from stemgnn_tpu_torch.utils.seeding import seed_everything

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def get_args():
    """``finetune.py``'s flags, defaults and aliases, plus ``--device``."""
    p = argparse.ArgumentParser("Finetune")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--gpu", type=int, default=0,
                   help="accepted for reference-CLI compatibility and "
                        "ignored (--device picks the device)")
    p.add_argument("--use_params", action="store_true",
                   help="apply the dataset's configs/finetune.yaml preset "
                        "under the explicit flags")
    p.add_argument("--setting", default="standard", choices=["standard"])
    p.add_argument("--pretrain_dataset", "--pt_data", default="na")
    p.add_argument("--pretrain_task", "--pt_task", default="all")
    p.add_argument("--pretrain_model_epoch", "--pt_epochs", type=int,
                   default=25)
    p.add_argument("--pretrain_run_id", "--pt_run_id", default="")
    p.add_argument("--pretrain_seed", "--pt_seed", type=int, default=42,
                   help="reference-CLI compatibility; checkpoints resolve "
                        "by --pretrain_run_id")
    p.add_argument("--pretrain_path", default="",
                   help="directory of encoder_<epoch>.npz / vq_<epoch>.npz, "
                        "as python -m stemgnn_tpu_torch.pretrain writes "
                        "them (default: ckpts/pretrain_model/<run_id>)")
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
    p.add_argument("--moe_layers", default="none",
                   choices=["none", "all", "last"])
    p.add_argument("--moe_experts", "--K", type=int, default=3)
    p.add_argument("--moe_tau", "--tau", type=float, default=1.0)
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
    p.add_argument("--text_encoder", default="hash",
                   choices=["hash", "tfidf", *NEURAL])
    p.add_argument("--save_model", default="",
                   help="write the best-val task model to this npz for "
                        "infer --mode predict")
    p.add_argument("--eval_every", type=int, default=1,
                   help="graph task: evaluate every K epochs (node and link "
                        "evaluate every epoch, as in JAX)")
    p.add_argument("--eval_bf16", type=int, default=0, choices=[0, 1])
    p.add_argument("--eval_batch_size", type=int, default=0,
                   help="graph task: eval batch size (node and link do not "
                        "read it, as in JAX)")
    p.add_argument("--eval_train_auc", type=int, default=1, choices=[0, 1])
    p.add_argument("--donate", action="store_true")
    p.add_argument("--eval_chunked", type=int, default=0, choices=[0, 1],
                   help="layer-wise streaming eval")
    p.add_argument("--use_fused_layout", type=int, default=1, choices=[0, 1])
    p.add_argument("--hub_size", type=int, default=2048)
    p.add_argument("--halo_balance", action="store_true")
    p.add_argument("--halo_order", default="none",
                   choices=["none", "balance", "rcm", "community"])
    p.add_argument("--reorder", default="auto",
                   choices=["auto", "off", "rcm", "degree", "community"])
    p.add_argument("--halo_shards", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def parse(argv=None):
    """The arguments: with ``--use_params`` the dataset's preset of
    ``configs/finetune.yaml`` becomes the defaults under the explicit flags
    (JAX finetune.py:145-162: ``encoder`` flattened, ``dataset``,
    ``epochs`` and ``lr`` renamed), then the wandb sweep round-trip (a
    no-op offline or with ``--debug``)."""
    parser = get_args()
    args = parser.parse_args(argv)
    task = dataset2task.get(args.finetune_dataset)
    if args.use_params:
        presets = cfglib.load_yaml(osp.join(ROOT, "configs", "finetune.yaml"))
        preset = presets.get(task, {}).get(args.finetune_dataset, {})
        rename = {"dataset": "finetune_dataset", "epochs": "finetune_epochs",
                  "lr": "finetune_lr"}
        flat = {}
        for k, v in preset.items():
            if k == "encoder":
                flat.update(v)
            else:
                flat[rename.get(k, k)] = v
        parser.set_defaults(**{k: v for k, v in flat.items()
                               if hasattr(args, k)})
        args = parser.parse_args(argv)
    return apply_wandb_sweep_config(args, "STEM-GNN-Finetune",
                                    debug=args.debug)


def refusals(args) -> list:
    """What the port does not cover among the given flag values, each with
    its ROADMAP item."""
    checks = (
        (args.donate, "--donate: buffer donation is a JAX mechanism with no "
                      "PyTorch counterpart (ROADMAP, differences kept on "
                      "purpose)"),
        (args.halo_shards < 0, "--halo_shards must be 0 or a number of "
                               "ranks"),
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
                             ("backbone", "backbone"), ("moe", "moe"),
                             ("num_experts", "moe_experts"),
                             ("tau", "moe_tau"),
                             ("moe_layers", "moe_layers")):
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
            activation=args.activation, moe=args.moe,
            num_experts=args.moe_experts, tau=args.moe_tau,
            moe_layers=args.moe_layers,
            compute_dtype="bfloat16" if args.bf16 else "float32"),
        vq=VQConfig(
            dim=args.hidden_dim, codebook_size=args.codebook_size,
            codebook_dim=args.code_dim, heads=args.codebook_head,
            decay=args.codebook_decay, commitment_weight=args.commit_weight,
            orthogonal_reg_weight=args.ortho_reg_weight,
            orthogonal_reg_max_codes=args.ortho_reg_max_codes,
            kmeans_init=True),
        dataset=args.finetune_dataset,
        task=dataset2task[args.finetune_dataset],
        epochs=args.finetune_epochs, early_stop=args.early_stop,
        batch_size=args.batch_size, lr=args.finetune_lr,
        repeat=1 if args.finetune_seed is not None else args.repeat,
        use_vq=bool(args.use_vq), freeze_vq=bool(args.freeze_vq),
        separate_decoder_for_each_head=bool(
            args.separate_decoder_for_each_head),
        decoder_jac_coeff=args.decoder_jac_coeff, lamda_env=args.lamda_env,
        num_classes=num_classes, eval_chunked=bool(args.eval_chunked),
        use_fused_layout=bool(args.use_fused_layout), hub_size=args.hub_size,
        reorder=args.reorder, eval_every=args.eval_every,
        eval_bf16=bool(args.eval_bf16), eval_batch_size=args.eval_batch_size,
        eval_train_auc=bool(args.eval_train_auc))


def main(argv=None, keep_z: bool = False):
    """Run the CLI.  Returns ``run_finetune``'s dict (the Logger and the
    last split's model, graph, step functions and history) for callers that
    go on working with them, as ``chip_smoke.py`` does; with
    ``--halo_shards`` the Logger and every rank's record
    (``parallel.full_graph.run_finetune_halo_parallel``; ``keep_z`` keeps
    each rank's final block of ``z``)."""
    args = parse(argv)
    bad = refusals(args)
    if bad:
        raise SystemExit("stemgnn_tpu_torch.finetune: " + "; ".join(bad))
    try:
        device = resolve_device(args.device)
    except RuntimeError as ex:
        raise SystemExit(f"stemgnn_tpu_torch.finetune: {ex}") from ex
    name = args.finetune_dataset
    task = dataset2task.get(name)
    if task is None:
        raise KeyError(f"Unknown dataset {name}")
    if args.halo_shards and task != "node":
        raise SystemExit("--halo_shards supports the node task")

    seed_everything(args.seed)
    ds = load_dataset(name, feat_dim=args.feat_dim, seed=args.seed,
                      text_encoder=args.text_encoder, device=device)
    check_feature_width(ds, args.feat_dim, args.text_encoder)
    enc, vq = _pretrained(args)
    # a graph dataset is (graphs, labels [G, T], split): T tasks
    cfg = make_config(args, ds[1].shape[1] if task == "graph"
                      else ds.num_classes)
    pretrained = None
    if enc is not None:
        encoder, quantizer = from_jax_pytree(
            {"encoder": enc["params"], "vq": vq["params"]},
            {"encoder": enc["state"], "vq": vq["state"]}, cfg)
        pretrained = {"encoder": encoder, "vq": quantizer}
        print("Loaded pretrained encoder and VQ.")
    if args.halo_shards:
        from stemgnn_tpu_torch.parallel.full_graph import \
            launch_halo_finetune
        try:
            ranks = launch_halo_finetune(
                ds, cfg, args.halo_shards, device.type,
                pretrained=pretrained, verbose=True,
                balance=args.halo_balance, order=args.halo_order,
                keep_z=keep_z)
        except ValueError as ex:
            raise SystemExit(f"stemgnn_tpu_torch.finetune: {ex}") from ex
        res = {"logger": ranks[0]["logger"], "ranks": ranks}
    else:
        res = run_finetune(ds, cfg, pretrained=pretrained, device=device,
                           verbose=True, save_model_to=args.save_model)
    best = res["logger"].get_best()
    for k, label in (("train", "train:"), ("val", "val:  "),
                     ("test", "test: ")):
        print("final/{} {:.2f} ± {:.2f}".format(label, best[k]["mean"],
                                                best[k]["std"]))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
