"""Pretrain CLI of the port (counterpart of the repo's ``pretrain.py``).

Merges the datasets of the ``--pretrain_dataset`` mix (``configs/
pt_data.yaml``, else ``{name: 1.0}``), runs the minibatch pretrain
(``train.pretrain_loop.run_pretrain``: the neighbour sampler, the four
losses, the EMA teacher, AdamW + clip + the cosine schedule) and writes
``encoder_<epoch>.npz``, ``vq_<epoch>.npz`` and ``full_<epoch>.npz`` with
``config.json`` under ``ckpts/pretrain_model/<run_id>/`` in the JAX
package's layout; ``--resume`` continues after the latest ``full_*.npz``
there.  The port's ``finetune`` and ``infer --mode encode`` read these
checkpoints.  ``--use_params`` takes the defaults of
``configs/pretrain.yaml``.

Runs on CUDA unless ``--device cpu`` is given; without CUDA and without
``--device cpu`` it exits with an error.  The config's
``fused_minibatch="auto"`` resolves to the gather + ``index_add_``
aggregation, as in JAX (``run_pretrain`` takes ``"on"`` for per-batch
layouts through the CUDA kernels).  ``--bf16`` computes the encoder in
bf16; ``--mixed_precision`` (``--mp``) also the VQ's per-head pipeline, the
EMA teacher's pass and the loss decoders (JAX pretrain.py:154-173), and the
resident feature tables are bf16 under either.  ``--moe`` (with
``--moe_layers``, ``--moe_experts``, ``--moe_tau`` and ``--lamda_env``)
and ``--backbone gcn|gin|gat`` train as in JAX.  ``--donate`` (a JAX
mechanism) is refused.  The neural text encoders run on ``--device`` from
a local snapshot (``data/text_encoder.py``).

``--halo_shards S`` (with ``--halo_hub H``) runs the full-graph halo
pretrain (``parallel.halo_pretrain``) on a data x edge grid of ranks:
torchrun's world when its environment is set, else ``num_data * S`` ranks
spawned here, ``num_data = max(cards // S, 1)`` on CUDA and 1 on the CPU
(gloo; ranks that share a card use gloo too).  ``--data_parallel`` runs
``run_pretrain`` on a data axis of ranks (``parallel.data_parallel``):
torchrun's world, else a rank a card (1 on the CPU).

  python -m stemgnn_tpu_torch.pretrain --pretrain_dataset arxiv_synthetic_pl
  python -m stemgnn_tpu_torch.pretrain --pretrain_dataset arxiv_synthetic_pl \\
      --resume --epochs 2
  python -m stemgnn_tpu_torch.pretrain --pretrain_dataset cora_synthetic \\
      --halo_shards 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import os.path as osp
import sys

from stemgnn_tpu_torch.core import config as cfglib
from stemgnn_tpu_torch.core.device import resolve_device
from stemgnn_tpu_torch.data.merge import merge_datasets
from stemgnn_tpu_torch.data.registry import (check_feature_width,
                                             load_dataset)
from stemgnn_tpu_torch.train.pretrain_loop import run_pretrain
from stemgnn_tpu_torch.utils.seeding import seed_everything

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def get_args():
    """The repo's ``pretrain.py`` flags, defaults and aliases, plus
    ``--device``."""
    p = argparse.ArgumentParser("Pretrain")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--text_encoder", default="hash",
                   choices=["hash", "tfidf", "ST", "st", "e5",
                            "llama2_7b", "llama2_13b"])
    p.add_argument("--debug", action="store_true")
    p.add_argument("--gpu", type=int, default=0,
                   help="accepted for reference-CLI compatibility and "
                        "ignored (--device picks the device)")
    p.add_argument("--use_params", action="store_true",
                   help="load configs/pretrain.yaml defaults")
    p.add_argument("--feat_dim", "--input_dim", type=int, default=768)
    p.add_argument("--hidden_dim", type=int, default=768)
    p.add_argument("--num_layers", "--layers", type=int, default=2)
    p.add_argument("--activation", "--act", default="relu")
    p.add_argument("--backbone", default="sage")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--save_every", type=int, default=1,
                   help="checkpoint every K epochs (the last always saves)")
    p.add_argument("--mixed_precision", "--mp", action="store_true")
    p.add_argument("--normalize", default="batch",
                   choices=["none", "batch", "layer"])
    p.add_argument("--dropout", type=float, default=0.15)
    p.add_argument("--code_dim", type=int, default=768)
    p.add_argument("--codebook_size", type=int, default=128)
    p.add_argument("--codebook_head", type=int, default=4)
    p.add_argument("--codebook_decay", type=float, default=0.8)
    p.add_argument("--commit_weight", type=float, default=10)
    p.add_argument("--ortho_reg_weight", type=float, default=1)
    p.add_argument("--ortho_reg_max_codes", type=int, default=32)
    p.add_argument("--moe", action="store_true")
    p.add_argument("--moe_layers", default="none",
                   choices=["none", "all", "last"])
    p.add_argument("--moe_experts", "--K", type=int, default=3)
    p.add_argument("--moe_tau", "--tau", type=float, default=1.0)
    p.add_argument("--lamda_env", type=float, default=0.0)
    p.add_argument("--pretrain_dataset", "--pt_data", default="synthetic")
    p.add_argument("--pretrain_run_id", "--pt_run_id", default="")
    p.add_argument("--pretrain_epochs", "--pt_epochs", "--epochs", type=int,
                   default=50)
    p.add_argument("--pretrain_lr", "--pt_lr", type=float, default=1e-4)
    p.add_argument("--pretrain_weight_decay", "--pt_decay", type=float,
                   default=1e-5)
    p.add_argument("--pretrain_batch_size", "--pt_batch", type=int,
                   default=1024)
    p.add_argument("--fanout", type=int, default=10)
    p.add_argument("--feat_p", type=float, default=0.2)
    p.add_argument("--edge_p", type=float, default=0.2)
    p.add_argument("--topo_recon_ratio", type=float, default=0.1)
    p.add_argument("--feat_lambda", type=float, default=100)
    p.add_argument("--topo_lambda", type=float, default=0.01)
    p.add_argument("--topo_sem_lambda", type=float, default=100)
    p.add_argument("--sem_lambda", type=float, default=1)
    p.add_argument("--sem_encoder_decay", type=float, default=0.99)
    # type=bool as in the repo's pretrain.py: any non-empty value is True
    p.add_argument("--use_schedular", "--use_scheduler", type=bool,
                   default=True)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--data_parallel", action="store_true")
    p.add_argument("--donate", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest full_<epoch>.npz bundle "
                        "under the run's checkpoint dir")
    p.add_argument("--halo_shards", type=int, default=0)
    p.add_argument("--halo_hub", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def refusals(args) -> list:
    """What the port does not cover among the given flag values, each with
    its ROADMAP item."""
    checks = (
        (args.donate, "--donate: buffer donation is a JAX mechanism with no "
                      "PyTorch counterpart (ROADMAP, differences kept on "
                      "purpose)"),
    )
    return [msg for bad, msg in checks if bad]


def parse(argv=None):
    """The arguments, with ``--use_params`` applying
    ``configs/pretrain.yaml`` as defaults under the explicit flags."""
    parser = get_args()
    args = parser.parse_args(argv)
    if args.use_params:
        preset = cfglib.load_yaml(osp.join(ROOT, "configs", "pretrain.yaml"))
        flat = {k: v for k, v in preset.items() if not isinstance(v, dict)}
        rename = {"epochs": "pretrain_epochs", "lr": "pretrain_lr",
                  "weight_decay": "pretrain_weight_decay",
                  "batch_size": "pretrain_batch_size",
                  "use_scheduler": "use_schedular"}
        flat = {rename.get(k, k): v for k, v in flat.items()}
        parser.set_defaults(**{k: v for k, v in flat.items()
                               if hasattr(args, k)})
        args = parser.parse_args(argv)
    return args


def make_config(args) -> cfglib.PretrainConfig:
    return cfglib.PretrainConfig(
        encoder=cfglib.EncoderConfig(
            input_dim=args.feat_dim, hidden_dim=args.hidden_dim,
            num_layers=args.num_layers, backbone=args.backbone,
            normalize=args.normalize, dropout=args.dropout,
            activation=args.activation, moe=args.moe,
            num_experts=args.moe_experts, tau=args.moe_tau,
            moe_layers=args.moe_layers,
            compute_dtype="bfloat16" if (args.bf16 or args.mixed_precision)
            else "float32"),
        vq=cfglib.VQConfig(
            dim=args.hidden_dim, codebook_size=args.codebook_size,
            codebook_dim=args.code_dim, heads=args.codebook_head,
            decay=args.codebook_decay, commitment_weight=args.commit_weight,
            orthogonal_reg_weight=args.ortho_reg_weight,
            orthogonal_reg_max_codes=args.ortho_reg_max_codes,
            compute_dtype="bfloat16" if args.mixed_precision
            else "float32"),
        epochs=args.pretrain_epochs, lr=args.pretrain_lr,
        weight_decay=args.pretrain_weight_decay,
        batch_size=args.pretrain_batch_size, fanout=args.fanout,
        feat_p=args.feat_p, edge_p=args.edge_p,
        topo_recon_ratio=args.topo_recon_ratio,
        feat_lambda=args.feat_lambda, topo_lambda=args.topo_lambda,
        topo_sem_lambda=args.topo_sem_lambda, sem_lambda=args.sem_lambda,
        sem_encoder_decay=args.sem_encoder_decay,
        lamda_env=args.lamda_env, use_scheduler=bool(args.use_schedular),
        teacher_bf16=args.mixed_precision, loss_bf16=args.mixed_precision,
        save_every=args.save_every, seed=args.seed)


def dataset_mix(name: str):
    """``(names, weights)`` of the pretrain mix ``name`` in
    ``configs/pt_data.yaml``, else ``([name], [1.0])``."""
    weights_map = cfglib.load_yaml(osp.join(ROOT, "configs", "pt_data.yaml"))
    mix = weights_map.get(name, {name: 1.0})
    return list(mix.keys()), list(mix.values())


def write_config(save_root: str, cfg: cfglib.PretrainConfig):
    """``config.json`` beside the checkpoints, in the JAX package's layout
    (``encoder``, ``vq`` and the rest under ``pretrain``)."""
    with open(osp.join(save_root, "config.json"), "w") as f:
        json.dump({"encoder": dataclasses.asdict(cfg.encoder),
                   "vq": dataclasses.asdict(cfg.vq),
                   "pretrain": {k: v for k, v in
                                dataclasses.asdict(cfg).items()
                                if k not in ("encoder", "vq")}},
                  f, indent=2, default=str)


def main(argv=None, record: bool = False):
    """Run the CLI.  Returns ``run_pretrain``'s ``(model, teacher,
    history)`` and the checkpoint directory, for callers that go on
    working with them, as ``chip_smoke.py`` does; under ``--halo_shards``
    or ``--data_parallel`` the ranks' records (rank 0's with the model and
    the teacher) and the checkpoint directory.  ``record`` has the halo
    ranks record their parameters' digests and keeps
    (``run_pretrain_halo``)."""
    args = parse(argv)
    bad = refusals(args)
    if bad:
        raise SystemExit("stemgnn_tpu_torch.pretrain: " + "; ".join(bad))
    try:
        device = resolve_device(args.device)
    except RuntimeError as ex:
        raise SystemExit(f"stemgnn_tpu_torch.pretrain: {ex}") from ex
    seed_everything(args.seed)

    names, weights = dataset_mix(args.pretrain_dataset)
    print(f"Pre-training on {names} (weights {weights})", flush=True)
    datasets = [load_dataset(n, feat_dim=args.feat_dim, seed=args.seed,
                             text_encoder=args.text_encoder, device=device)
                for n in names]
    for ds in datasets:
        check_feature_width(ds, args.feat_dim, args.text_encoder)
    merged = merge_datasets(datasets)
    cfg = make_config(args)

    run_id = args.pretrain_run_id or "default"
    save_root = osp.join(ROOT, "ckpts", "pretrain_model", run_id)
    os.makedirs(save_root, exist_ok=True)
    write_config(save_root, cfg)
    if args.halo_shards:
        from stemgnn_tpu_torch.parallel.halo_pretrain import \
            launch_halo_pretrain
        out = (launch_halo_pretrain(merged, cfg, args.halo_shards,
                                    device.type, weights=weights,
                                    save_root=save_root,
                                    hub_size=args.halo_hub, record=record),)
    elif args.data_parallel:
        from stemgnn_tpu_torch.parallel.data_parallel import \
            launch_dp_pretrain
        out = (launch_dp_pretrain(merged, cfg, device.type, weights=weights,
                                  save_root=save_root,
                                  max_steps=args.max_steps,
                                  resume=args.resume),)
    else:
        out = run_pretrain(merged, cfg, weights=weights, save_root=save_root,
                           max_steps=args.max_steps, resume=args.resume,
                           device=device)
    print(f"Checkpoints saved under {save_root}", flush=True)
    return out + (save_root,)


if __name__ == "__main__":
    main(sys.argv[1:])
