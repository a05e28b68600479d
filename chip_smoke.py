#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's entry points at arxiv scale (``arxiv_synthetic_pl``:
169,343 nodes, 2,370,802 edges, D = 768, 2-layer SAGE + 4-head cosine VQ,
random weights from a seeded generator): the full-graph pretrain step, the
encode CLI and the node finetune CLI, the minibatch pretrain, the
typed-edge link finetune on ``kg_synthetic`` (11 relation types, at its
default size and at WN18RR's 40,943 entities and 93,003 triples), the five
robustness evaluations and the reference's link presets on the cached
WN18RR and FB15K237, and holds every CUDA kernel of their paths against its
plain PyTorch version; then the graph tasks on molecules, mixed precision,
the MoE-SAGE layer and the gcn / gin / gat backbones, and cora from raw
files through the language-model text encoders.  Phases, each
announced before it starts and timed when it ends:

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds the three kernels from ``stemgnn_tpu_torch/csrc``,
               one compiler per source, started together;
  3. kernel  — ``scatter_rows_sorted`` vs its plain version over the row
               plan: small cases (sentinel padding over large padded
               messages, empty node blocks and rows, every relu/init/scale/
               gate combination, bf16/f32 in and out, both edge orders,
               split rows, messages zeroed by a dropout keep, idle lanes,
               the pairs layout), then the forward and backward (gate)
               tails at arxiv shapes, with each tail's row plan described;
  4. kernel2 — ``gathered_scatter_rows_sorted`` vs its plain version: small
               cases (no table, t0, a 5-row xe table; every epilogue; bf16/
               f32 out; empty node blocks and empty rows under init/scale/
               gate; sentinel padding over large padded rows; both edge
               orders; rows longer than the row plan's chunk, which the
               second pass finishes; widths that leave lanes idle or take
               the pairs layout), then the forward and backward hub tails
               at arxiv shapes, with each tail's row plan described;
  5. kernel3 — ``masked_scatter_rows_sorted`` vs its plain version: small
               cases (no table, T = 1, 5, 11; bf16/f32 dm and out; empty node
               blocks; sentinel padding over padded rows of 1e30; senders
               that are not their row; split rows; idle lanes; the pairs
               layout), then the sender-order layout of the arxiv graph
               with 11 random edge types (its row plan built and timed on
               the host), timed; kernel 2's xe mode on the same graph's
               receiver order, timed likewise;
  6. slice   — ``stemgnn_tpu_torch.infer.main`` (encode) from a JAX-format
               checkpoint in a temporary directory: 2 kernel-2 launches and
               no kernel-1 launch; outputs checked; the same encoder on
               ``gwin="off"`` layouts (2 kernel-1 launches) and through the
               plain versions, ``z`` compared;
  7. train   — ``stemgnn_tpu_torch.finetune.main``, 2 epochs, dropout 0
               (phase halo's single-device reference): 3 kernel-2
               launches per training step and 2 per evaluation, finite
               losses, trainable parameters moved and the frozen VQ not,
               one step's gradients against the plain versions and against
               the ``gwin="off"`` route; epoch and step times, peak memory;
  8. pretrain — the full-graph pretrain step (``train.pretrain_loop``:
               the pair-hash edge dropout, the four losses, the EMA
               teacher, the learnable VQ, AdamW + clip + cosine schedule),
               3 steps at full width: kernel 1 three times a step (the
               student's dropout tails: two forward, layer 2's input
               gradient), kernel 2 twice (the teacher's tails), finite
               losses that move, every parameter and the teacher moved,
               one step's gradients against the plain versions, the pair
               hash on the card against the CPU's; step ms, peak memory;
               kernel 1 on the step's dropout tails vs its plain version;
  9. pretrain_mb — the minibatch pretrain: the native sampler built from
               the port's copy of its source (the native route asserted);
               the CLI chain at full width on ``arxiv_synthetic_pl``
               (``pretrain.main`` for one epoch cut at 4 steps, a resume
               that saves epoch 2, ``finetune.main`` (1 epoch) and
               ``infer.main`` from those checkpoints, and a finetune with no
               checkpoint (1 epoch),
               whose codebook is k-means-initialized), its run directory
               removed at the end; then ``run_pretrain`` on both routes,
               6 steps each: ``"on"`` (each batch's own layout) launches
               kernel 1 three times and kernel 2 twice a step, ``"auto"``
               neither; finite losses that move, one step's gradients on
               the ``"on"`` route against the plain versions, step ms,
               wall ms a step, the sampler's and the layout build's host
               ms a batch, the idle share and peak memory;
 10. vq      — the VQ's training options through ``run_pretrain`` at full
               width, 4 steps each on batches of 128 seeds (no layout, no
               kernel): the cosine codebook with ``ema_update`` and
               ``threshold_ema_dead_code=2`` (the dead codes replaced a
               step counted and printed), and a euclidean codebook with
               ``affine_param``, stochastic and straight-through Gumbel
               sampling and the EMA; finite losses, the codebook moved and
               equal to the adopted EMA target, the cluster sizes moved,
               the affine statistics updated; for each run one step on
               one batch on the card against the CPU with the same draws
               (the loss within 1e-3 relative, the gradients within the
               step gate, the VQ state after it within 1e-4 of each
               entry's largest: the EMA sums, cluster sizes, target and
               replaced dead codes on the codes whose nodes agree, the
               affine statistics whole; the cosine run's step replaces
               dead codes);
 11. typed   — the link finetune on typed edges: ``finetune.main`` on
               ``kg_synthetic``, then ``run_finetune`` at WN18RR's size, 3
               epochs each: kernel 3 once per step, kernel 2 (xe mode)
               twice per step and twice per evaluation, kernel 1 never;
               finite losses, one step's gradients against the plain
               versions; step ms, epoch walls, peak memory;
 12. ood     — the five robustness evaluations, each script's ``main``
               (``stemgnn_tpu_torch.scripts.*``) with one run of 2 epochs
               at full width on ``arxiv_synthetic_fragile`` (169,343 nodes,
               the graph they were built for): ``tri_objective`` (four
               missing-feature re-evaluations), ``random_edge_drop``,
               ``degree_shift_ood``, ``homophily_shift_ood`` and
               ``missing_feature`` (from this run's checkpoint, with its
               TSV; the others k-means-initialize the codebook): kernel 2
               twice in the k-means init, five times an epoch and twice a
               re-evaluation, kernels 1 and 3 never; the JSON keys of the
               JAX scripts, accuracies finite and in [0, 100]; on the
               edge-dropped and the missing-feature graphs, the best
               snapshot's ``z`` and one step's gradients against the plain
               versions; wall, host seconds of the buckets, perturbations
               and layout builds (the five share one build of the training
               graph's layout, as every phase shares a dataset's graph; a
               missing-feature re-evaluation swaps its features into it),
               step / eval ms, peak memory;
 13. kg      — the reference's knowledge-graph link presets through
               ``finetune.main --use_params`` on the repository's cached
               WN18RR (40,943 entities, 93,003 triples, 11 relations; full
               batch, 2 epochs) and FB15K237 (14,537 entities, 38,001
               triples, 228 relations; batches of 1,024 edges with 30
               neighbours over 2 hops, 2 epochs, ``--save_model``), one edge
               text each (T = 1, the factored branch): entities, edges,
               classes and hub blocks; kernel 2 twice in the k-means init,
               three times a full-batch step, twice an evaluation and never
               in a minibatch step, kernels 1 and 3 never; finite losses;
               WN18RR's encoder and decoder moved and its frozen VQ not,
               one step's gradients and ``z`` against the plain versions,
               step and evaluation ms, and kernel 2 checked and timed at
               its evaluation's first launch; FB15K237's batches, host ms
               a batch (sampler, copies), batch step ms, idle share and
               evaluation ms; ``infer.main --mode predict`` on the saved
               model (probabilities of all 38,001 edges, rows summing to
               1, the best epoch's predictions); one epoch with
               ``--eval_chunked 1`` (no full graph, no kernel), its
               layer-wise ``z`` against the fused encode and its
               probabilities against the fused evaluation's where the
               edges' endpoints keep their VQ codes (the ``z``
               tolerance; at least 90% of the edges keep them); ``infer
               .main --mode encode`` on WN18RR and on ``kg_synthetic`` (11
               types: typed hubs and kernel 2's xe mode), kernel 2 twice
               each, ``z`` against the CPU's layout route (the ``z``
               gates), the quantized rows where the codes agree likewise;
 14. graph   — the graph tasks, which launch no kernel (a molecule batch
               carries no layout, as in JAX): ``finetune.main --use_params``
               on ``mol_synthetic`` (600 graphs, 4 tasks, batches of 64, 2
               epochs; the materialized bundle, the host AUC), then 3,000
               random valence-safe molecules (of MoleculeNet HIV's 41,127;
               128 tasks, 60% NaN, 80/10/10), written to a
               CSV under ``chiprun_out/``, featurized once, through
               ``finetune.main --finetune_dataset smiles:<csv>`` with
               chemhiv's preset values as flags (batches of 1,024, lr
               3e-4), 2 epochs with
               ``--save_model`` (the indexed bundle, the device AUC), then
               ``infer.main --mode predict`` on the saved model and ``infer
               .main --mode encode`` from phase slice's checkpoint: no
               launch of any kernel; finite losses; the history's build /
               copy host ms a batch, step ms, idle share and each split's
               evaluation ms; the AUCs; the device AUC against the host AUC
               over the best evaluation's predictions (1e-6); the predicted
               probabilities against that evaluation's sigmoid (1e-6; a
               molecule at a near-tie of two VQ codes may take the other
               code in another batching, and is shown to); one step's
               gradients against the plain route; peak memory;
 15. mp      — mixed precision: (a) the full-graph pretrain step under
               ``pretrain.py --mixed_precision`` on phase pretrain's graph
               and layout, 3 steps: kernel 1 three times a step (the
               dropout tails, bf16 init and out), kernel 2 twice (the bf16
               teacher's tails, bf16 out); the first bf16-output launch of
               each checked against its plain version (one bf16 ulp) and
               timed beside its bound; the losses against the f32 forward
               on the same parameters and draws within the JAX package's
               2% gate, with cuBLAS's bf16 split-K reductions allowed and
               not; one step's gradients (f32) against the plain versions;
               step ms, the stage split, peak memory; (b) the pretrain CLI
               with ``--mixed_precision`` (``fused_minibatch`` auto: no
               kernel) and its config on ``"on"`` through ``run_pretrain``
               (kernel 1 x 3 and kernel 2 x 2 a step), 2 steps each; (c)
               ``finetune --bf16`` on the node task (kernel 2 with bf16
               out) and the typed link task on ``kg_synthetic`` (kernel 2's
               xe mode and kernel 3 with bf16 out), 2 epochs each, those
               launches checked and timed, ``z`` against the plain route;
               (d) the graph task on ``mol_synthetic`` with ``--bf16`` and
               with ``--eval_bf16 1`` (the evaluation's ``z`` bf16, the
               device AUC against the host AUC, 1e-6);
 16. times   — kernels 1 and 2, their plain versions, bounds and yardsticks
               at the main paths' shapes (kernel 1 also on the pretrain
               step's dropout tails), by CUDA events;
 17. backbones — the MoE-SAGE layer and the gcn / gin / gat backbones at
               full width on ``arxiv_synthetic_pl``: (a) ``finetune.main
               --moe --moe_layers last --lamda_env 0.1`` from an MoE
               checkpoint written here, 2 epochs (layer 1, sage, through
               kernel 2 once a step and once an evaluation; the MoE layer
               by gathers and ``index_add_``), the ``[MoE]`` usage lines,
               the scaled env term below 0, one step's gradients against
               the plain versions; (b) the full-graph pretrain step with
               the same flags on phase pretrain's graph, 3 steps (kernel 1
               once a step on layer 1's dropout tail, kernel 2 once on the
               teacher's), ``env_reg_loss`` below 0, one step's gradients
               against the plain versions; (c) ``--backbone gcn``, ``gin``
               and ``gat`` from scratch, 1 epoch each (no layout, no
               kernel, as in JAX; gat with ``--eval_chunked 1``); (d) the
               layer-wise evaluation of gat's and (a)'s models: ``z``
               against the full f32 encode, probabilities against the full
               evaluation's; (e)
               ``degree_shift_ood --moe --lamda_env 0.1`` on the shared
               ``arxiv_synthetic_fragile`` (kernel 2 once in the k-means
               init, twice an epoch).  For each: launches, step and
               evaluation ms by CUDA events, peak memory;
 18. locality — the node relabels: ``finetune.main --reorder off | rcm |
               community | degree`` on ``arxiv_synthetic`` (169,343 nodes,
               2,370,802 edges), 1 epoch each, dropout 0, from phase
               slice's checkpoint: kernel 2 five times a run, each
               relabelled run's loss within 1e-3 relative of the
               unrelabelled run's, its ``z`` mapped back through
               ``node_perm`` against the unrelabelled graph's (the ``z``
               gates), each relabel's host seconds; WN18RR's preset with
               ``--reorder community``, 1 epoch, link labels and splits in
               their slots; then the local/stray split: a shuffled
               ``community_power_law_graph`` (169,343 nodes, 1,166,243
               edges, 640 communities), community-ordered (with its
               layouts built in a thread beside phase backbones), with
               ``loc_split="on"`` and the merged metadata, without and with
               hub blocks (2,048 + 2,048, forced): the fused aggregation
               forward and backward, f32 and bf16 (the hub case f32 only),
               through the two launches
               (kernels 1 and 2 once a direction) and the merged launch
               (kernel 2 once a direction; hub tails carry no merged
               metadata, as in JAX), against the plain versions and the
               unsplit layout; kernel 2's merged launch with its stray
               inputs, and the chain's kernel 1 and kernel 2 launches,
               checked and timed like every kernel case (``time_case``);
               the unsplit kernel 2, the two-launch chain and the merged
               route timed on the same edges;
 19. halo    — the halo full-graph finetune on ``torch.distributed``:
               phase train's flags (the arxiv graph, 2 epochs, dropout 0,
               phase slice's checkpoint) with ``--halo_shards 2`` (two
               ranks sharing the card over gloo, their processes started
               at phase backbones) and beside it ``--halo_shards 1`` (this
               process, NCCL): each epoch's loss within 1e-3 relative of
               phase train's, each rank's block of the final ``z`` against
               phase train's final ``z`` (the ``z`` gates), kernel 2 ten
               times on each rank's local layout (at S = 2 ten times on its
               remote one too, at S = 1 none on its empty remote layout)
               and kernels 1 and 3 never (counted on the layouts' row
               plans);
               each rank's partition and layout host seconds, R, the bytes
               exchanged a layer, the exchanges' device ms (CUDA events),
               epoch, step and evaluation ms and the idle share; rank 1's
               remote layout rebuilt here beside phase backbones, its
               kernel-2 launch (layer 1's forward over the exchanged rows)
               checked against its plain version and timed like every
               case (``time_case``);
 20. text    — bring-your-own data and the text encoders, with the cache
               root in a temporary directory: (a) cora's raw files at its
               size (a PyG ``cora.pt`` of 2,708 texts of 150-250 words
               over a synthetic 30,522-entry WordPiece vocabulary, 10,556
               directed edges with duplicates, 7 classes, and
               ``categories.csv``) and a seeded DistilBERT snapshot at
               multi-qa-distilbert-cos-v1's widths (6 x 768, 12 heads, FFN
               3,072) through ``finetune.main --finetune_dataset cora
               --use_params --text_encoder ST``, 2 epochs: the texts
               encoded on the card, kernel 2 twice in the k-means init and
               five times an epoch; 32 texts' embeddings on the card
               against the CPU's on the same weights; (b) ST on 512
               generated texts; (c) e5 at e5-large-v2's widths (24 x
               1,024, 16 heads, FFN 4,096) from a snapshot on 128 texts,
               card against CPU on 4; (d) Llama-2-7B's widths (32 x 4,096,
               32 heads, FFN 11,008) built on the card from the seed, 16
               rows of about 128 ids, card against CPU on its first 2
               layers; (e) a reference PyG cache of cora imported and an
               ``.st`` memmap cache written and read back.  For each
               encoder: texts/s, tokens/s, host tokenizing ms and device ms
               (CUDA events) a batch, the idle share and peak memory;
 21. halo_pretrain — multi-GPU pretraining on ``torch.distributed``:
               (a) ``pretrain.main --halo_shards 2 --halo_hub 2048`` on the
               arxiv graph at full width (phase pretrain's configuration,
               dropout 0), 3 epochs of one step, two ranks sharing the card
               over gloo (started beside phases halo and text), then step 1
               alone with ``--halo_shards 1`` in this process (NCCL): every
               rank's pair-hash keeps over global ids on the card against
               the CPU's (each layout's edges
               and count blocks), the parameters bit-equal across ranks after
               each step, kernel 1 three times and kernel 2 twice a step on
               each rank's local and remote layout (where its forward tail
               gathers in the kernel; counted on the layouts' row plans), step
               1's feat, sem and commit losses at S = 2 within 1e-3 relative
               of S = 1's and the topo losses finite; each rank's partition
               and layout host seconds, step and exchange ms (CUDA events),
               idle share and peak GB; kernel 1 on rank 1's dropped remote
               hub tail (built here beside the S = 2 run) checked against
               its plain version and timed; (b) a 2 x 2 grid (four ranks on
               the card) on an eighth of the arxiv graph's nodes at full
               width, 2 epochs: the same gates but the S = 1 comparison; (c)
               ``run_pretrain`` with ``mesh`` (``--data_parallel``) on two
               ranks at phase pretrain_mb's batches, 4 steps (no layout):
               the parameters bit-equal across ranks, each rank's kernel
               launches (counted in the rank, zeroed just before its run)
               0, device ms a step, wall, idle share and peak GB.  (b) and
               (c) run in a thread beside phases kg, graph and mp (their
               ranks are processes of their own, so their launches and the
               smoke's are counted apart); their gates run here.

 22. ofa     — the OFA in-context and few-shot path (``ofa/*``, ``zoo/*``;
               no kernel, as in JAX) at full width (D = 768, 2 layers,
               batches of 16 prompted graphs, JAX's buckets), one epoch
               each from initial weights drawn on the CPU: (a)
               ``ofa_train_eval`` on ``SubgraphNodeDataset`` over the arxiv
               graph's valid split (the task constructor's; 2 hops of at
               most 100 nodes, hierarchical prompt), 128 train and 64
               eval targets, gine; (b) the prompted KG task
               (``TaskConstructor.make_link_dataset``) on ``kg_synthetic``
               at WN18RR's size, 128 / 64 triples, rgcn then rgat (8 heads
               of 96); (c) ``fewshot_train_eval``, 3-way 2-shot on arxiv's
               low-resource class split, 32 / 16 episodes in batches of 8;
               (d) ``task="multi"`` on ``GraphListHierDataset`` over
               ``mol_synthetic`` (NaN labels excluded), 256 / 128; (e) 4
               AdamW steps of ``BinGraphHead`` with attention pooling and
               RWPE (walks of 16) on batches of (a)'s dataset.  For each:
               samples/s, host ms a batch (sample, prompt, collate, copy),
               device ms a step and an evaluation batch (CUDA events), the
               idle share, peak memory, first and last loss and the
               metric (in [0, 1]); kernel launches gated at 0; a batch of
               4 prompted graphs (2 episodes) of the same dataset, from
               the same initial weights: its loss on the card within 1e-4
               relative of the CPU's and its gradients within 2% of the
               largest (the CPU's side in a thread beside the card's
               run).  The datasets and their adjacencies are built beside
               phase halo_pretrain; every sample is drawn in this phase.
 23. edge_parallel — the v1 edge-partitioned full-graph finetune
               (``parallel.full_graph.launch_edge_parallel_finetune``) on
               the arxiv graph at full width (D = 768, 2-layer sage, the
               4-head VQ not initted, dropout 0, 2 epochs, 1 split): S = 2
               (two ranks sharing the card over gloo, started at phase
               ofa and run beside it), then S = 1 in this process (NCCL);
               each epoch's loss at S = 2 within 1e-3 relative of S = 1's,
               the ranks' parameters bit-equal after training, kernel 2
               twice on rank 0 (its k-means init's encode of the fused
               full graph) and never on rank 1, twice at S = 1, kernels 1
               and 3 never (counted in each rank, zeroed just before its
               run, and on the k-means graph's row plans); the S = 1
               init's two kernel-2 launches recorded, checked against the
               plain version and timed (``launch_case``); the two shards'
               ``sharded_sage_aggregate`` summed against the
               single-device ``gather_scatter_aggregate`` on the card
               (sum and mean, 1e-4 relative); one training step stamped
               by ``utils.timer.DeviceTimer`` against its CUDA events.
               Per rank: the shard build's host seconds, step and
               evaluation ms, the all-reduces a step and their ms (CUDA
               events), the idle share and peak GB.

PyTorch's compiler stack, which every optimizer imports when it is built
(seconds of host time), is imported beside phase build, and so is the
process that every rank process is forked from (``parallel.mesh``).  Each dataset is
generated or read once and shared by the phases that load it, and so is
each full graph (and layout) of such a dataset
(``shared_datasets``; the entry points change none of their arrays): a
wall printed for an entry point counts a layout build only where it built
the graph first (the slice's encode wall is printed with the build of its
graph in phase kernel).  Prints the
``{"kernels": [...]}`` line of this run's measurements, the
card's name and power limit, and as its last line ``{"ok": true,
"device": {...}}``.  Exits non-zero, with no result line, on any failure and
when no CUDA device is available.  Writes nothing into the repository but
the build directory of the kernels and the sampler and the graph phase's
molecules under ``chiprun_out/`` (the pretrain CLI's checkpoints are
removed at the end of their phase; the evaluations' TSV goes to a
temporary directory).
"""

import concurrent.futures
import contextlib
import copy
import dataclasses
import importlib
import inspect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import (EncoderConfig, FinetuneConfig,
                                           VQConfig)
from stemgnn_tpu_torch import finetune as finetune_cli
from stemgnn_tpu_torch.data import (importers, native_sampler, raw_parsers,
                                    registry, text_encoder)
from stemgnn_tpu_torch.data.merge import merge_datasets
from stemgnn_tpu_torch.data.registry import load_dataset
from stemgnn_tpu_torch.data.sampler import (CSCGraph, NeighborBatchIterator,
                                            get_train_node_idx)
from stemgnn_tpu_torch.eval import runner as eval_runner
from stemgnn_tpu_torch.eval.runner import snapshot_model
from stemgnn_tpu_torch import infer as infer_cli
from stemgnn_tpu_torch.infer import main as infer_main
from stemgnn_tpu_torch import pretrain as pretrain_cli
from stemgnn_tpu_torch.nn.encoder import Encoder
from stemgnn_tpu_torch.nn.layers import Linear
from stemgnn_tpu_torch.ops import fused_sage
from stemgnn_tpu_torch.ops import scatter as sc
from stemgnn_tpu_torch.models.pretrain import (PretrainModel, make_teacher,
                                               pretrain_forward)
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout, row_plan
from stemgnn_tpu_torch.ops.fused_sage import (DropView, hub_partials,
                                              inv_deg, table_row,
                                              tail_messages)
from stemgnn_tpu_torch.ops.pairhash import pair_hash_keep, pair_hash_uniform
from stemgnn_tpu_torch.models.task import TaskModel
from stemgnn_tpu_torch.models.task import encode as task_encode
from stemgnn_tpu_torch.models.task import pool_graph
from stemgnn_tpu_torch.profile_pretrain import (STAGES, dropout_tail_cases,
                                                pretrain_config, stage_ms)
from stemgnn_tpu_torch.scripts import _common as scripts_common
from stemgnn_tpu_torch.scripts import (degree_shift_ood, homophily_shift_ood,
                                       missing_feature, random_edge_drop,
                                       tri_objective)
from stemgnn_tpu_torch.data.synthetic import (community_power_law_graph,
                                              write_smiles_csv)
from stemgnn_tpu_torch.ops.reorder import community_order, relabel
from stemgnn_tpu_torch.core.graph import graph_to_device, round_up
from stemgnn_tpu_torch.ofa import datasets as ofa_datasets
from stemgnn_tpu_torch.ofa import fewshot as ofa_fewshot
from stemgnn_tpu_torch.ofa import heads as ofa_heads
from stemgnn_tpu_torch.ofa import prompt as ofa_prompt
from stemgnn_tpu_torch.ofa import tasks as ofa_tasks
from stemgnn_tpu_torch.ofa import train as ofa_train
from stemgnn_tpu_torch.train.optim import Optimizer
from stemgnn_tpu_torch.parallel import halo, mesh
from stemgnn_tpu_torch.parallel.data_parallel import launch_dp_pretrain
from stemgnn_tpu_torch.parallel.edge_partition import (
    partition_edges_by_destination, sharded_sage_aggregate)
from stemgnn_tpu_torch.parallel.full_graph import (
    launch_edge_parallel_finetune, make_edge_parallel_steps,
    prepare_sharded_graph)
from stemgnn_tpu_torch.ops.spmm import gather_scatter_aggregate
from stemgnn_tpu_torch.utils.timer import DeviceTimer
from stemgnn_tpu_torch.parallel.halo_pretrain import (halo_pretrain_arrays,
                                                      launch_halo_pretrain)
from stemgnn_tpu_torch.train.augment import dropout_edge_seed
from stemgnn_tpu_torch.data.text_encoder import (E5Encoder, LlamaEncoder,
                                                 SentenceEncoder)
from stemgnn_tpu_torch.nn.bert import BertConfig, BertModel
from stemgnn_tpu_torch.nn.distilbert import (DistilBertConfig,
                                             WordPieceTokenizer, load_into)
from stemgnn_tpu_torch.nn.llama import LlamaConfig, LlamaModel
from stemgnn_tpu_torch.train import finetune_loop, graph_setup
from stemgnn_tpu_torch.train.finetune_loop import (_batch_graph_list,
                                                   _graph_feeder,
                                                   _make_node_steps,
                                                   run_finetune)
from stemgnn_tpu_torch.train.graph_setup import (describe_layout,
                                                 fused_full_graph)
from stemgnn_tpu_torch.train.infer import (layerwise_encode,
                                           layerwise_eval_predict)
from stemgnn_tpu_torch.train import pretrain_loop
from stemgnn_tpu_torch.train.pretrain_loop import (augmented, batch_graph,
                                                   draw_step,
                                                   make_pretrain_optimizer,
                                                   make_pretrain_step,
                                                   run_pretrain)
from stemgnn_tpu_torch.utils.checkpoint import save_pytree
from stemgnn_tpu_torch.utils.convert import from_jax_pytree, to_jax_pytree
from stemgnn_tpu_torch.utils.metrics import device_multitask_auc, eval_auc
from stemgnn_tpu_torch.vq import codebook as cb
from stemgnn_tpu_torch.vq.quantize import VectorQuantize

DATASET = "arxiv_synthetic_pl"
FEAT_DIM = 768
NUM_CLASSES = 40
SEED = 42
# the finetunes' epochs (3 until the text phase came: PERF.md, section 4)
EPOCHS = 2
PRETRAIN_STEPS = 3
# phase mp: the full-graph steps and the minibatch steps of each route
# under --mixed_precision, and the losses held to the JAX package's gate
MP_STEPS, MP_MB_STEPS = 3, 2
MP_LOSSES = ("feat_recon_loss", "topo_recon_loss", "topo_sem_recon_loss",
             "sem_recon_loss", "commit_loss")
# the minibatch pretrain: the reference's batches (pretrain.yaml), the
# steps of each run_pretrain route and the epochs of the finetunes that
# follow the pretrain CLI
MB_BATCH, MB_FANOUT, MB_STEPS, MB_FT_EPOCHS = 1024, 10, 6, 1
HBM_BPS = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12          # H100 SXM data sheet, f32 outside tensor cores
K1, K2 = "scatter_rows_sorted", "gathered_scatter_rows_sorted"
K3 = "masked_scatter_rows_sorted"
# each kernel's wrapper and plain version, and the names of its arrays
KERNEL_FNS = {K1: (sc.scatter_rows_sorted, sc.scatter_rows_sorted_ref),
              K2: (sc.gathered_scatter_rows_sorted,
                   sc.gathered_scatter_rows_sorted_ref),
              K3: (sc.masked_scatter_rows_sorted,
                   sc.masked_scatter_rows_sorted_ref)}
POSITIONAL = {K1: ("m", "local_row", "block_ptr"),
              K2: ("keys", "local_row", "block_ptr", "x", "table", "xe"),
              K3: ("m", "local_row", "senders", "block_ptr", "x", "table",
                   "xe")}
KG = "kg_synthetic"
KG_TYPES = 11
# phase locality: the relabelled finetunes' dataset and orders, their loss
# gate against the unrelabelled run, and the shuffled community graph of
# the local/stray split (arxiv's node count and ogbn-arxiv's 1,166,243
# edges; communities of ~265 nodes, so that one fits the split's reach of
# 256 rows about its block's median)
LOCALITY = "arxiv_synthetic"
REORDERS = ("rcm", "community", "degree")
LOC_LOSS_RTOL = 1e-3
LOC_NODES, LOC_EDGES, LOC_COMMUNITIES = 169_343, 1_166_243, 640
# phase vq: run_pretrain's steps and batch (seeds) with each VQ option (a
# batch of 128 seeds gives each of the 128 codes of a head ~25 rows, so
# codes a batch leaves under 10 rows fall below the dead-code threshold 2
# after the first EMA step: 1,024 seeds left none dead in 4 steps), and
# the seeds of the batch the card is held against the CPU on
VQ_STEPS, VQ_BATCH, VQ_CHECK_BATCH = 4, 128, 32
# the VQ state after the card's step against the CPU's: each entry within
# this share of its largest magnitude (f32 on both devices, where only the
# order of the sums differs)
VQ_STATE_RTOL = 1e-4
# WN18RR's entity and triple counts (the generator keeps its 11 relations)
WN18RR_ENTITIES, WN18RR_TRIPLES = 40_943, 93_003
# phase ofa: (train, eval) targets of the node, KG and molecule tasks, the
# few-shot (n_way, k_shot, train, eval episodes) and its batch, the
# prompted graphs a batch (JAX's default), the bin-graph head's steps and
# its random walks' length.  The node task and the few-shot run half the
# targets and episodes they first ran (256 / 128, 64 / 32): the numpy
# sampler takes ~9 ms of host a graph, and with them the smoke went 13 s
# over its 4 minutes (PERF.md, section 4)
OFA_NODE, OFA_KG, OFA_MOL = (128, 64), (128, 64), (256, 128)
OFA_FS, OFA_FS_BATCH = (3, 2, 32, 16), 8
OFA_BATCH, OFA_HEAD_STEPS, OFA_WALK = 16, 4, 16
# the card-against-CPU gates' batches: prompted graphs, few-shot episodes
# (the CPU's side of a full batch at D = 768 took its cores from the
# sampler beside it)
OFA_GATE, OFA_FS_GATE = 4, 2
# the graph phase's indexed bundle with PCBA's 128 tasks: 3,000 molecules
# of MoleculeNet HIV's 41,127 (the reference's chemhiv); the host work of
# 41,127, then of 20,000, took the whole smoke past its 4 minutes with the
# later phases (PERF.md, section 4)
MOLECULES, MOL_TASKS = 3_000, 128
# the robustness evaluations' graph and the JSON keys of the JAX scripts
# (scripts/*.py): the payload's, and one run's row
OOD_DATASET = "arxiv_synthetic_fragile"
OOD_KEYS = {
    "tri_objective": (
        ["buckets", "boundaries", "runs", "summary"],
        ["fit", "ood", "perturb", "perturb_p0.2", "perturb_p0.4",
         "perturb_p0.6", "perturb_p0.8", "OOD3", "OOD2", "OOD1", "ID",
         "best_epoch"]),
    "random_edge_drop": (
        ["drop_prob", "drop_mode", "perturb", "runs", "summary"],
        ["clean/train", "clean/valid", "clean/test", "perturbed/train",
         "perturbed/valid", "perturbed/test", "best_epoch"]),
    "degree_shift_ood": (
        ["buckets", "boundaries", "runs", "summary"],
        ["OOD-low", "ID", "OOD-high", "split/train", "split/valid",
         "split/test", "best_epoch"]),
    "homophily_shift_ood": (
        ["buckets", "boundaries", "diagnostics", "runs", "summary"],
        ["OOD-low", "ID", "OOD-high", "best_epoch"]),
    "missing_feature": (
        ["missing_prob", "perturb", "runs", "summary"],
        ["clean/train", "clean/valid", "clean/test", "perturbed/train",
         "perturbed/valid", "perturbed/test", "best_epoch"]),
}
# f32 sums of the same values in another order; bf16 outputs may differ by
# one bf16 ulp (<= 2^-7 relative) where the f32 values straddle a rounding
TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2.0 ** -7, 1e-3)}
# z through one route vs z through another: the layer-1 sums differ only in
# order, but layer 2 rounds its input to bf16 messages again, so a
# difference can flip one bf16 rounding (the bf16-message tolerance)
Z_RTOL, Z_ATOL = 3e-2, 1e-2
# one training step's gradients on two routes: the same bf16 messages summed
# in another order, so only a few bf16 roundings of layer 2's input and of
# gp flip; each parameter's worst difference against 2% of the largest
# gradient of the step
GRAD_RTOL = 2e-2


def finetune_main(argv):
    """``finetune.main`` with ``--debug``: the wandb sweep round-trip off,
    so that no run imports wandb or reaches for a host (the smoke runs
    offline)."""
    return finetune_cli.main(argv if "--debug" in argv
                             else [*argv, "--debug"])


def phase(name):
    """Context manager printing a flushed line before and after a phase."""
    class _P:
        def __enter__(self):
            print(f"[phase {name}] start", flush=True)
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            ok = "ok" if exc[0] is None else "FAILED"
            print(f"[phase {name}] {ok} in "
                  f"{time.perf_counter() - self.t0:.1f} s", flush=True)
            return False
    return _P()


def card_line():
    if shutil.which("nvidia-smi"):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        return out[0]
    return f"{torch.cuda.get_device_name(0)}, power limit unknown"


def ptxas_summary(log):
    """Registers and spills per compiled function from ``-Xptxas -v``: the
    range over all template instances, each instance that spills, and the
    instances the arxiv paths launch (whole rows of 768 columns: ``Li8ELi3E``
    in the mangled name)."""
    funcs, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], 0
        elif name and "bytes spill stores" in line:
            spill = int(line.split("bytes stack frame, ")[1].split()[0])
        elif name and "Used" in line and "registers" in line:
            funcs.append((name, int(line.split("Used ")[1].split()[0]),
                          spill))
            name = None
    if not funcs:
        return "    (no ptxas report)"
    regs = [r for _, r, _ in funcs]
    lines = [f"    {len(funcs)} functions, {min(regs)}-{max(regs)} registers,"
             f" {sum(1 for f in funcs if f[2])} spill"]
    for fn, r, sp in funcs:
        if sp or "Li8ELi3E" in fn:
            lines.append(f"    {r:4d} registers, {sp:3d} B spilled: {fn}")
    return "\n".join(lines)


def max_err(got, want):
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def check_close(tag, got, want, rtol, atol, what="kernel", quiet=False):
    err = max_err(got, want)
    excess = float(((got.float() - want.float()).abs()
                    - (atol + rtol * want.float().abs())).max())
    if not quiet or excess > 0:
        print(f"  {tag}: max_abs_err {err:.3e} (rtol {rtol:.1e}, atol "
              f"{atol:.0e}) {'ok' if excess <= 0 else 'FAIL'}", flush=True)
    if excess > 0:
        raise AssertionError(f"{tag}: {what} disagrees (max_abs_err "
                             f"{err:.3e})")
    return err


def check_kernel(tag, got, want, out_dtype, quiet=False):
    torch.cuda.synchronize()
    return check_close(tag, got, want, *TOL[out_dtype], quiet=quiet)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events, after
    two warm-up runs."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def reset_counts():
    for k in sc.launch_counts:
        sc.launch_counts[k] = 0
    torch.cuda.synchronize()


def read_counts():
    torch.cuda.synchronize()
    return dict(sc.launch_counts)


def expect_counts(tag, got, want):
    """``want`` names the kernels expected to launch; every other kernel
    must not."""
    want = {k: want.get(k, 0) for k in got}
    print(f"  {tag}: launches {got}", flush=True)
    if got != want:
        raise AssertionError(f"{tag}: expected launches {want}, got {got}")


def _epilogue_opts(rng_t, n_pad, d, init, scale, gate, gate_dtype, dev):
    opt = {}
    if init:
        opt["init"] = torch.randn(n_pad, d, device=dev, generator=rng_t)
    if scale:
        opt["scale"] = torch.rand(n_pad, 1, device=dev, generator=rng_t) + .5
    if gate:
        opt["gate"] = torch.randn(n_pad, d, device=dev,
                                  generator=rng_t).to(gate_dtype)
    return opt


def kernel1_small_cases(dev):
    """Kernel 1 vs its plain version on layouts that exercise the walk:
    every relu/init/scale/gate combination with bf16/f32 messages and
    outputs, both edge orders, padded message slots holding large values,
    empty node blocks and empty rows, split rows (rows longer than the
    plan's chunk, finished by the second pass), messages zeroed by a
    dropout keep, idle lanes and both column layouts."""
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_cases = 0

    def run(tag, lay, n_pad, d, mdt, odt, relu, init, scale, gate,
            order="r", chunk=None, keep_p=None):
        nonlocal n_cases
        e = lay.num_edges_padded
        m = rng.standard_normal((e, d)).astype(np.float32)
        m[~getattr(lay, "mask_" + order).cpu().numpy()] = 1.0e30
        if keep_p is not None:              # dropped edges' zero messages
            m[rng.random(e) < keep_p] = 0.0
        m = torch.from_numpy(m).to(dev, mdt)
        opt = _epilogue_opts(gen, n_pad, d, init, scale, gate, mdt, dev)
        lrow = getattr(lay, "lrow_" + order)
        bp = getattr(lay, "block_ptr_" + order)
        plan = (row_plan(lrow, bp, chunk=chunk) if chunk
                else getattr(lay, "plan_" + order))
        args = (m, lrow, bp)
        kw = dict(num_nodes_padded=n_pad, relu=relu, out_dtype=odt, **opt)
        check_kernel(tag, sc.scatter_rows_sorted(*args, plan=plan, **kw),
                     sc.scatter_rows_sorted_ref(*args, **kw), odt, quiet=True)
        n_cases += 1

    # uniform random graph, 56 trailing empty rows, padded edge slots
    s = rng.integers(0, 200, 700)
    r = rng.integers(0, 200, 700)
    lay = build_edge_layout(s, r, 256, device=dev)
    for mdt in (torch.bfloat16, torch.float32):
        for odt in (torch.float32, torch.bfloat16):
            for flags in range(16):
                relu, init, scale, gate = (bool(flags & 1), bool(flags & 2),
                                           bool(flags & 4), bool(flags & 8))
                tag = (f"uniform d=64 {str(mdt)[6:]}->{str(odt)[6:]} "
                       f"relu={relu:d} init={init:d} scale={scale:d} "
                       f"gate={gate:d}")
                run(tag, lay, 256, 64, mdt, odt, relu, init, scale, gate)
            for order in ("r", "s"):
                run(f"uniform d=64 {str(mdt)[6:]}->{str(odt)[6:]} order="
                    f"{order} chunk=3 (split rows) relu init scale gate",
                    lay, 256, 64, mdt, odt, order == "r", True, True, True,
                    order=order, chunk=3)
                run(f"uniform d=64 {str(mdt)[6:]}->{str(odt)[6:]} order="
                    f"{order} keep-zeroed messages relu init scale", lay,
                    256, 64, mdt, odt, order == "r", True, True, False,
                    order=order, keep_p=0.3)
    # a 2000-edge hub receiver (many unroll batches in one block), a run of
    # one-edge nodes, a mid-size hub, fully empty node blocks
    r = np.concatenate([np.zeros(2000, np.int64), np.arange(600),
                        np.full(300, 1400)])
    s = rng.permutation(r)
    lay = build_edge_layout(s, r, 2048, device=dev)
    for d in (8, 96, 130, 768):    # idle lanes, the pairs layout, full rows
        run(f"stress d={d} bf16->f32 relu init scale (split rows)", lay,
            2048, d, torch.bfloat16, torch.float32, True, True, True, False)
        run(f"stress d={d} f32->f32", lay, 2048, d, torch.float32,
            torch.float32, False, False, False, False)
        run(f"stress d={d} sender order gate, keep-zeroed", lay, 2048, d,
            torch.bfloat16, torch.float32, False, True, False, True,
            order="s", keep_p=0.2)
    print(f"  kernel 1: {n_cases} small cases agree with the plain version",
          flush=True)


def kernel2_small_cases(dev):
    """Kernel 2 vs its plain version: every table form and epilogue, both
    out dtypes, both edge orders, empty blocks, sentinel padding, split
    rows, idle lanes and both column layouts (whole rows, pairs)."""
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(1)
    n_cases = 0

    def run(tag, lay, order, x, table, xe, odt, relu, init, scale, gate,
            plan=None):
        nonlocal n_cases
        n_pad, d = x.shape
        opt = _epilogue_opts(gen, n_pad, d, init, scale, gate,
                             torch.bfloat16, dev)
        keys = lay.senders_r if order == "r" else lay.receivers_s
        args = (keys[None, :], getattr(lay, "lrow_" + order),
                getattr(lay, "block_ptr_" + order), x, table, xe)
        kw = dict(num_nodes_padded=n_pad, relu=relu, out_dtype=odt, **opt)
        plan = plan or getattr(lay, "plan_" + order)
        check_kernel(tag,
                     sc.gathered_scatter_rows_sorted(*args, plan=plan, **kw),
                     sc.gathered_scatter_rows_sorted_ref(*args, **kw), odt,
                     quiet=True)
        n_cases += 1

    # uniform graph over 200 of 256 rows (56 empty rows), 324 sentinel-padded
    # edge slots; padded rows of x hold large finite values (never read)
    n, n_pad, d = 200, 256, 64
    s = rng.integers(0, n, 700)
    r = rng.integers(0, n, 700)
    xe_ids = rng.integers(0, 5, 700)
    lay = build_edge_layout(s, r, n_pad, xe_ids=xe_ids, device=dev)
    x = torch.randn(n_pad, d, device=dev, generator=gen)
    x[n:] = 1.0e30
    x = x.to(torch.bfloat16)
    tables = {"none": (None, None),
              "t0": (torch.randn(1, d, device=dev, generator=gen)
                     .to(torch.bfloat16), None),
              "xe5": (torch.randn(5, d, device=dev, generator=gen)
                      .to(torch.bfloat16), None)}
    for name, (table, _) in tables.items():
        for order in ("r", "s"):
            xe = (getattr(lay, "xe_" + order)[None, :] if name == "xe5"
                  else None)
            for odt in (torch.float32, torch.bfloat16):
                for flags in range(16):
                    relu, init, scale, gate = (
                        bool(flags & 1), bool(flags & 2), bool(flags & 4),
                        bool(flags & 8))
                    tag = (f"table={name} order={order} ->{str(odt)[6:]} "
                           f"relu={relu:d} init={init:d} scale={scale:d} "
                           f"gate={gate:d}")
                    run(tag, lay, order, x, table, xe, odt, relu, init,
                        scale, gate)
            # rows longer than a 3-edge chunk: most rows split, the second
            # pass finishes them; the empty rows still get init/scale/gate
            small = row_plan(getattr(lay, "lrow_" + order),
                             getattr(lay, "block_ptr_" + order),
                             keys=(lay.senders_r if order == "r"
                                   else lay.receivers_s),
                             xe=getattr(lay, "xe_" + order), chunk=3)
            run(f"table={name} order={order} chunk=3 (split rows) "
                f"relu init scale gate", lay, order, x, table, xe,
                torch.float32, True, True, True, True, plan=small)
    # hub receivers (rows of 2000 and 300 edges, longer than the chunk) and
    # empty blocks, at widths that leave lanes idle (8, 96), take the pairs
    # layout (130) or fill every lane (768)
    r = np.concatenate([np.zeros(2000, np.int64), np.arange(600),
                        np.full(300, 1400)])
    s = rng.permutation(r)
    lay = build_edge_layout(s, r, 2048, device=dev)
    for d in (8, 96, 130, 768):
        xs = torch.randn(2048, d, device=dev, generator=gen).to(torch.bfloat16)
        t0 = torch.randn(1, d, device=dev, generator=gen).to(torch.bfloat16)
        run(f"stress d={d} t0 relu init scale (split rows)", lay, "r", xs,
            t0, None, torch.float32, True, True, True, False)
        run(f"stress d={d} sender order gate", lay, "s", xs, None, None,
            torch.float32, False, True, False, True)
    print(f"  kernel 2: {n_cases} small cases agree with the plain version",
          flush=True)


def kernel3_small_cases(dev):
    """Kernel 3 vs its plain version: no table and 1-, 5- and 11-row
    tables, bf16/f32 dm and out, empty node blocks, sentinel padding over
    padded rows of x holding 1e30, the receiver-order arrays (senders that
    are not their row, read through the cache), split rows, idle lanes and
    both column layouts (whole rows, pairs)."""
    rng = np.random.default_rng(3)
    gen = torch.Generator(device=dev).manual_seed(3)
    n_cases = 0

    def run(tag, lay, order, x, table, dt, odt, chunk=None):
        nonlocal n_cases
        e = lay.num_edges_padded
        dm = torch.randn(e, x.shape[1], device=dev, generator=gen).to(dt)
        mask = getattr(lay, "mask_" + order)
        dm = torch.where(mask[:, None], dm, torch.zeros((), dtype=dt,
                                                         device=dev))
        xe = (None if table is None
              else getattr(lay, "xe_" + order)[None, :])
        senders = getattr(lay, "senders_" + order)
        args = (dm, getattr(lay, "lrow_" + order), senders[None, :],
                getattr(lay, "block_ptr_" + order), x, table, xe)
        plan = lay.plan_s
        if order == "r" or chunk:
            plan = row_plan(args[1], args[3], senders=senders,
                            xe=getattr(lay, "xe_" + order),
                            chunk=chunk or lay.plan_s.chunk)
        kw = dict(num_nodes_padded=x.shape[0], out_dtype=odt)
        check_kernel(tag,
                     sc.masked_scatter_rows_sorted(*args, plan=plan, **kw),
                     sc.masked_scatter_rows_sorted_ref(*args, **kw), odt,
                     quiet=True)
        n_cases += 1

    # uniform graph over 200 of 256 rows (56 empty rows), sentinel-padded
    # edge slots from a graph's edge padding; padded rows of x hold 1e30
    n, n_pad, d, e = 200, 256, 64, 700
    s = np.concatenate([rng.integers(0, n, e), np.zeros(324, np.int64)])
    r = np.concatenate([rng.integers(0, n, e), np.zeros(324, np.int64)])
    x = torch.randn(n_pad, d, device=dev, generator=gen)
    x[n:] = 1.0e30
    x = x.to(torch.bfloat16)
    for t_rows in (0, 1, 5, 11):
        xe_ids = rng.integers(0, max(t_rows, 1), len(s))
        lay = build_edge_layout(s, r, n_pad, xe_ids=xe_ids,
                                edge_mask=np.arange(len(s)) < e, device=dev)
        table = (None if t_rows == 0 else
                 torch.randn(t_rows, d, device=dev, generator=gen)
                 .to(torch.bfloat16))
        for order in ("s", "r"):
            for dt in (torch.bfloat16, torch.float32):
                for odt in (torch.float32, torch.bfloat16):
                    run(f"T={t_rows} order={order} {str(dt)[6:]}->"
                        f"{str(odt)[6:]}", lay, order, x, table, dt, odt)
            run(f"T={t_rows} order={order} chunk=3 (split rows)", lay,
                order, x, table, torch.bfloat16, torch.float32, chunk=3)
    # a 2000-edge hub sender (split over several items), a run of one-edge
    # nodes, a mid-size hub, fully empty node blocks, at widths that leave
    # lanes idle (8, 96), take the pairs layout (130) or fill every lane
    s = np.concatenate([np.zeros(2000, np.int64), np.arange(600),
                        np.full(300, 1400)])
    r = rng.permutation(s)
    xe_ids = rng.integers(0, KG_TYPES, len(s))
    lay = build_edge_layout(s, r, 2048, xe_ids=xe_ids, device=dev)
    for d in (8, 96, 130, 768):
        xs = torch.randn(2048, d, device=dev, generator=gen).to(torch.bfloat16)
        table = torch.randn(KG_TYPES, d, device=dev,
                            generator=gen).to(torch.bfloat16)
        run(f"stress d={d} T=11", lay, "s", xs, table, torch.bfloat16,
            torch.float32)
        run(f"stress d={d} no table", lay, "s", xs, None, torch.float32,
            torch.float32)
    print(f"  kernel 3: {n_cases} small cases agree with the plain version",
          flush=True)


def plan_bytes(plan):
    return sum(t.numel() * t.element_size() for t in (
        plan.pos, plan.item_row, plan.item_start, plan.item_slot,
        plan.split_row, plan.split_ptr, plan.keys, plan.senders, plan.xe)
        if t is not None)


def kernel3_arxiv(ds, dev):
    """Kernel 3 on the whole sender-order layout of the arxiv graph with 11
    random edge types (its full-graph typed backward), and kernel 2's xe
    mode on the same layout's receiver order (the typed forward without
    hubs): each checked against its plain version and timed
    (:func:`time_case`).  Returns ({kernel: max_abs_err}, {kernel:
    times})."""
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s, r = (np.asarray(a, np.int32) for a in ds.edge_index)
    n_pad = -(-ds.num_nodes // 128) * 128
    lay = build_edge_layout(s, r, n_pad,
                            xe_ids=rng.integers(0, KG_TYPES, len(s)),
                            num_edge_types=KG_TYPES, device=dev)
    e_used = int(lay.block_ptr_s[-1])
    # the row plan of one direction, built again on its own to time it
    t0 = time.perf_counter()
    plan = row_plan(lay.lrow_s, lay.block_ptr_s, keys=lay.receivers_s,
                    senders=lay.senders_s, xe=lay.xe_s)
    plan_s = time.perf_counter() - t0
    print(f"  row plan of the sender order: {plan_s:.3f} s on the host, "
          f"{plan_bytes(plan) / 1e6:.1f} MB on the card; {plan.num_items} "
          f"items of at most {plan.chunk} edges, {plan.num_split} split rows "
          f"over {plan.num_slots} items", flush=True)
    del plan
    for order in ("s", "r"):
        per_block = torch.diff(getattr(lay, "block_ptr_" + order))
        owner = lay.receivers_r if order == "r" else lay.senders_s
        deg = torch.bincount(owner[:e_used], minlength=n_pad)
        print(f"  order {order}: node blocks hold up to "
              f"{int(per_block.max())} edges (mean "
              f"{float(per_block.float().mean()):.0f}); rows up to "
              f"{int(deg.max())} edges", flush=True)
    x, table, dm = seeded_typed_inputs(lay, dev, gen)
    tag = f"T={KG_TYPES}"
    errs, times = {}, {}
    # kernel 3 over the whole sender order (dm, f32 out), and kernel 2's xe
    # mode over the whole receiver order (relu, f32 sums, no epilogue: the
    # typed forward without hubs)
    for name, direction, call in (
            (K3, "arxiv", ((dm, lay.lrow_s, lay.senders_s[None, :],
                            lay.block_ptr_s, x, table, lay.xe_s[None, :]),
                           dict(num_nodes_padded=n_pad, plan=lay.plan_s))),
            (K2, "xe", ((lay.senders_r[None, :], lay.lrow_r,
                         lay.block_ptr_r, x, table, lay.xe_r[None, :]),
                        dict(num_nodes_padded=n_pad, relu=True,
                             plan=lay.plan_r)))):
        errs[name], times[name] = launch_case(
            f"{name} arxiv {'sender' if name == K3 else 'receiver'} order "
            f"{tag}", name, direction, call)
    del lay, x, table, dm
    torch.cuda.empty_cache()
    return errs, times


def typed_run(tmp, dev, paths):
    """The typed-edge link finetune: the CLI on ``kg_synthetic`` at its
    default size, then ``run_finetune`` at WN18RR's size from the same
    checkpoint, with launch counts, losses, gradients and times."""
    argv = ["--finetune_dataset", KG, "--feat_dim", str(FEAT_DIM),
            "--pretrain_path", tmp, "--pretrain_model_epoch", "50",
            "--seed", str(SEED), "--epochs", str(EPOCHS), "--repeat", "1"]
    print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)}",
          flush=True)
    per_epoch = {K1: 0, K2: 2 + 2, K3: 1}
    want = {k: EPOCHS * v for k, v in per_epoch.items()}
    reset_counts()
    res = finetune_main(argv)
    paths["typed_cli"] = read_counts()
    expect_counts(f"{KG} CLI finetune ({EPOCHS} x (train step + eval))",
                  paths["typed_cli"], want)
    check_losses(res)
    check_link_step(res)
    del res

    # the same flags, the dataset at WN18RR's scale
    args = finetune_cli.get_args().parse_args(argv)
    enc, vq = finetune_cli._pretrained(args)
    ds = load_dataset(KG, feat_dim=FEAT_DIM, seed=SEED,
                      num_entities=WN18RR_ENTITIES, num_edges=WN18RR_TRIPLES)
    cfg = finetune_cli.make_config(args, ds.num_classes)
    encoder, quantizer = from_jax_pytree(
        {"encoder": enc["params"], "vq": vq["params"]},
        {"encoder": enc["state"], "vq": vq["state"]}, cfg)
    print(f"  run_finetune on {KG} with {ds.num_nodes} entities, "
          f"{ds.num_edges} triples, {KG_TYPES} relations", flush=True)
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    reset_counts()
    t0 = time.perf_counter()
    res = run_finetune(ds, cfg, pretrained={"encoder": encoder,
                                            "vq": quantizer},
                       device=dev, verbose=True)
    paths["typed"] = read_counts()
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  finetune wall {wall_s:.2f} s ({EPOCHS} epochs); per-epoch "
          f"wall {['%.3f' % s for s in res['epoch_s']]} s; peak device "
          f"memory {peak_gb:.2f} GB, {peak_gb - held_gb:.2f} GB above the "
          f"{held_gb:.2f} GB that earlier phases still held", flush=True)
    expect_counts(f"WN18RR-scale finetune ({EPOCHS} x (train step + eval))",
                  paths["typed"], want)
    check_losses(res)
    check_link_step(res)
    model, g, y, mask = res["model"], res["graph"], res["y"], res[
        "train_mask"]
    _, train_step, eval_step = res["steps"]
    opt = torch.optim.AdamW([p for p in model.parameters()
                             if p.requires_grad], lr=1e-3, weight_decay=0.01)
    gen = torch.Generator(device=dev).manual_seed(0)
    step_ms = cuda_ms(lambda: train_step(model, opt, mask, g, y, gen), 5)
    eval_ms = cuda_ms(lambda: eval_step(model, g), 5)
    print(f"  link training step {step_ms:.3f} ms, evaluation "
          f"{eval_ms:.3f} ms, by CUDA events", flush=True)
    path = kernel3_path_case(g.layout, dev)
    del res, model, g
    return path


def seeded_typed_inputs(lay, dev, gen):
    """Seeded bf16 x, type table and dm (zero off the sender order's real
    edges) for kernel 3 and kernel 2's xe mode on the typed layout
    ``lay``."""
    x = torch.randn(lay.num_nodes_padded, FEAT_DIM, device=dev,
                    generator=gen).to(torch.bfloat16)
    table = torch.randn(KG_TYPES, FEAT_DIM, device=dev, generator=gen).to(
        torch.bfloat16)
    dm = torch.randn(lay.num_edges_padded, FEAT_DIM, device=dev,
                     generator=gen, dtype=torch.bfloat16)
    dm.masked_fill_(~lay.mask_s[:, None], 0)
    return x, table, dm


def kernel3_path_case(lay, dev):
    """Kernel 3 at the link finetune's own backward shape (the WN18RR-scale
    sender-order layout, D = 768, bf16 dm, f32 out) on seeded random
    values: checked and timed (:func:`launch_case`)."""
    x, table, dm = seeded_typed_inputs(
        lay, dev, torch.Generator(device=dev).manual_seed(SEED))
    return launch_case(
        "kernel 3 at the link path's shape", K3, "path",
        ((dm, lay.lrow_s, lay.senders_s[None, :], lay.block_ptr_s, x, table,
          lay.xe_s[None, :]),
         dict(num_nodes_padded=lay.num_nodes_padded, plan=lay.plan_s)))


def check_link_step(res):
    """One link step's launches and gradients against the plain versions,
    one evaluation's launches, on the run's own layout."""
    model, g, y, mask = res["model"], res["graph"], res["y"], res[
        "train_mask"]
    loss_fn, _, eval_step = res["steps"]
    reset_counts()
    g_kernel = step_grads(model, loss_fn, mask, g, y)
    expect_counts("one link training step", read_counts(), {K2: 2, K3: 1})
    reset_counts()
    eval_step(model, g)
    expect_counts("one link evaluation", read_counts(), {K2: 2})
    check_grads("the plain versions", g_kernel,
                step_grads(model, loss_fn, mask, g, y, plain=True))


def check_losses(res, epochs=EPOCHS):
    losses = [e["loss"] for e in res["epoch_losses"]]
    print(f"  losses {losses}", flush=True)
    if len(losses) != epochs or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")


def arxiv_tail_cases(graph):
    """The main path's real launches, as ``ops.fused_sage`` makes them: the
    forward hub tail of layer 1 (receiver order, relu, t0, the hub partial
    sums as init, 1/deg as scale) and the backward hub tail (sender order,
    gp = g / deg in bf16, the hub partial sums of gp as init, the relu gate
    bf16(x) + t0).  Returns each kernel's two launches as (arguments of
    the kernel and its plain version, keywords of both, keywords of the
    kernel alone: the tail's row plan)."""
    lay = graph.layout
    if lay.hub_r is None or lay.hub_s is None:
        raise AssertionError("the arxiv-scale layout has no hub blocks")
    if not (lay.hub_r.tail.use_gwin_r and lay.hub_s.tail.use_gwin_s):
        raise AssertionError("the default arxiv layout's tails do not open "
                             "the in-kernel gather gate")
    dev = graph.node_feat.device
    src = graph.node_feat.to(torch.bfloat16)
    t0 = table_row(graph.edge_table, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(2)
    gp = (torch.randn(src.shape, device=dev, generator=gen)
          * inv_deg(lay)).to(torch.bfloat16)
    ft, bt = lay.hub_r.tail, lay.hub_s.tail
    n_pad = lay.num_nodes_padded
    fwd_epi = dict(num_nodes_padded=n_pad, relu=True,
                   init=hub_partials(src, lay.hub_r, t0), scale=inv_deg(lay),
                   out_dtype=torch.float32)
    bwd_epi = dict(num_nodes_padded=n_pad, relu=False,
                   init=hub_partials(gp, lay.hub_s, None, relu=False),
                   gate=src + t0, out_dtype=torch.float32)
    k1 = {"fwd": (dict(m=tail_messages(src, ft, t0), local_row=ft.lrow_r,
                       block_ptr=ft.block_ptr_r), fwd_epi,
                  dict(plan=ft.plan_r)),
          "bwd": (dict(m=tail_messages(gp, bt, None, "s"),
                       local_row=bt.lrow_s, block_ptr=bt.block_ptr_s),
                  bwd_epi, dict(plan=bt.plan_s))}
    k2 = {"fwd": (dict(keys=ft.senders_r[None, :], local_row=ft.lrow_r,
                       block_ptr=ft.block_ptr_r, x=src, table=t0), fwd_epi,
                  dict(plan=ft.plan_r)),
          "bwd": (dict(keys=bt.receivers_s[None, :], local_row=bt.lrow_s,
                       block_ptr=bt.block_ptr_s, x=gp), bwd_epi,
                  dict(plan=bt.plan_s))}
    return k1, k2


def pretrain_run(graph, dev, paths, errs):
    """The full-graph pretrain step on the arxiv graph at full width
    (``train.pretrain_loop``, the JAX step probe's configuration: 2-layer
    SAGE with batch norm and dropout 0.15, the 4-head cosine VQ with 128
    learnable codes, the four losses, the EMA teacher, AdamW + clip 1.0 +
    the cosine schedule, the pair-hash edge dropout at p = 0.2), random
    weights from ``SEED``: ``PRETRAIN_STEPS`` steps with their launches
    (kernel 1 on the student's three dropout tails, kernel 2 on the
    teacher's two tails, a step), finite losses that move, every parameter
    and the teacher moved, one step's gradients against the plain versions,
    the on-card keep decisions against the CPU hash, step ms and peak
    memory; kernel 1 on the step's dropout tails against its plain version.
    Returns those tail cases for the times phase."""
    cfg = pretrain_config(FEAT_DIM)
    model = PretrainModel(
        cfg, generator=torch.Generator().manual_seed(SEED)).to(dev)
    teacher = make_teacher(model)
    opt = make_pretrain_optimizer(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bs = graph.num_nodes_padded
    step = make_pretrain_step(cfg, bs, generator=gen)
    before = [p.detach().clone() for p in model.parameters()]
    t_before = [p.detach().clone() for p in teacher.parameters()]
    print(f"  pretrain step at bs = {bs}: {sum(p.numel() for p in before)} "
          f"student parameters, teacher {sum(p.numel() for p in t_before)}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    reset_counts()
    t0 = time.perf_counter()
    losses = [{k: float(v) for k, v in step(model, teacher, opt, graph)
               .items()} for _ in range(PRETRAIN_STEPS)]
    paths["pretrain"] = read_counts()
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  {PRETRAIN_STEPS} steps in {wall_s:.2f} s (first step "
          f"included); peak device memory {peak_gb:.2f} GB, "
          f"{peak_gb - held_gb:.2f} GB above the {held_gb:.2f} GB held "
          f"before", flush=True)
    expect_counts(f"pretrain ({PRETRAIN_STEPS} steps)", paths["pretrain"],
                  {K1: 3 * PRETRAIN_STEPS, K2: 2 * PRETRAIN_STEPS})
    for i, ls in enumerate(losses):
        print(f"  step {i}: " + ", ".join(f"{k} {v:.6f}"
                                          for k, v in ls.items()),
              flush=True)
    totals = [ls["loss"] for ls in losses]
    if not all(np.isfinite(v) for ls in losses for v in ls.values()):
        raise AssertionError(f"non-finite pretrain losses {losses}")
    if len(set(totals)) == 1:
        raise AssertionError(f"the pretrain loss does not move: {totals}")
    for tag, old, mod in (("student", before, model),
                          ("teacher", t_before, teacher)):
        still = sum(torch.equal(a, b) for a, b in zip(old, mod.parameters()))
        if still:
            raise AssertionError(f"{still} {tag} parameters did not move")
    print("  every student and teacher parameter moved", flush=True)

    draws = draw_step(cfg, graph, torch.Generator(device=dev).manual_seed(7))
    aug = augmented(cfg, graph, draws)

    def grads(plain):
        m, t = copy.deepcopy(model), copy.deepcopy(teacher)
        loss, _, _ = pretrain_forward(
            m, t, cfg, aug, graph, bs=bs, draws=draws,
            drop_seed=draws["drop_seed"], plain=plain,
            generator=torch.Generator(device=dev).manual_seed(7))
        loss.backward()
        return {k: p.grad for k, p in m.named_parameters()}
    reset_counts()
    g_kernel = grads(False)
    expect_counts("one pretrain forward + backward", read_counts(),
                  {K1: 3, K2: 2})
    check_grads("the plain versions", g_kernel, grads(True))
    del g_kernel

    # the pair hash on the card against the CPU: every edge's uniform (bit
    # for bit) and keep, and a (node, hub) grid's keeps
    seed, p = draws["drop_seed"], cfg.edge_p
    s_, r_ = graph.senders, graph.receivers
    on_card = pair_hash_uniform(seed, s_, r_).cpu()
    on_cpu = pair_hash_uniform(seed.cpu(), s_.cpu(), r_.cpu())
    rows = torch.arange(16_384, device=dev)
    hubs = graph.layout.hub_r.hub_ids
    grid = pair_hash_keep(seed, rows[:, None], hubs[None, :], p).cpu()
    if not (torch.equal(on_card.view(torch.int32), on_cpu.view(torch.int32))
            and torch.equal(pair_hash_keep(seed, s_, r_, p).cpu(),
                            on_cpu >= torch.tensor(p, dtype=torch.float32))
            and torch.equal(grid, pair_hash_keep(
                seed.cpu(), rows.cpu()[:, None], hubs.cpu()[None, :], p))):
        raise AssertionError("the pair hash on the card differs from the CPU")
    print(f"  pair hash on the card equals the CPU's: {s_.numel()} edge "
          f"uniforms bit for bit ({int((on_cpu >= p).sum())} of them "
          f"kept at p = {p}), "
          f"{grid.numel()} (node, hub) keeps", flush=True)

    step_ms = cuda_ms(lambda: step(model, teacher, opt, graph), 3)
    print(f"  pretrain step {step_ms:.3f} ms by CUDA events (mean of 3)",
          flush=True)

    view = DropView(graph.layout, seed, p)
    src = aug.node_feat.to(torch.bfloat16)
    cases = dropout_tail_cases(graph, view, src,
                               table_row(graph.edge_table, torch.bfloat16))
    for direction, (args, kw, plan) in cases.items():
        errs[(K1, direction)] = check_kernel(
            f"kernel 1 on the pretrain {direction} tail E_pad="
            f"{args['m'].shape[0]} D={FEAT_DIM}",
            sc.scatter_rows_sorted(**args, **kw, **plan),
            sc.scatter_rows_sorted_ref(**args, **kw), torch.float32)
    del model, teacher, opt, draws, aug, view
    torch.cuda.empty_cache()
    return cases


def mb_check_losses(tag, hist, steps):
    """One epoch's history of ``run_pretrain``: ``steps`` steps whose
    losses are finite and move."""
    losses = [v for h in hist for v in h["step_losses"]]
    print(f"  {tag}: step losses {['%.4f' % v for v in losses]}", flush=True)
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: losses {losses}")
    if len(set(losses)) == 1:
        raise AssertionError(f"{tag}: the loss does not move")


def remove_run_dir(save_root):
    """Remove a pretrain run's directory and then its parents
    (``ckpts/pretrain_model``, ``ckpts``) where they are left empty."""
    shutil.rmtree(save_root, ignore_errors=True)
    parent = os.path.dirname(save_root)
    for _ in range(2):
        try:
            os.rmdir(parent)
        except OSError:
            break
        parent = os.path.dirname(parent)


def pretrain_mb_cli(ds, tmp, dev, paths):
    """The CLI chain at full width: pretrain (one epoch cut at 8 steps), a
    resume that saves epoch 2, the node finetune and the encode from the
    port's own checkpoint, then a finetune with no checkpoint (the k-means
    init); the run directory is removed at the end."""
    run_id = f"chip_smoke_mb_{os.getpid()}"
    base = ["--pretrain_dataset", DATASET, "--feat_dim", str(FEAT_DIM),
            "--seed", str(SEED), "--pretrain_run_id", run_id, "--epochs",
            "2"]
    save_root = None
    try:
        for tag, steps, epoch in (("pretrain", 4, 1), ("resume", 2, 2)):
            extra = (["--resume"] if epoch == 2 else []) + [
                "--max_steps", str(steps)]
            argv = base + extra
            print(f"  python -m stemgnn_tpu_torch.pretrain {' '.join(argv)}",
                  flush=True)
            reset_counts()
            t0 = time.perf_counter()
            _, _, hist, save_root = pretrain_cli.main(argv)
            paths[f"pretrain_cli_{tag}"] = read_counts()
            print(f"  {tag} wall {time.perf_counter() - t0:.2f} s "
                  f"(dataset, sampler set-up, {len(hist[0]['step_losses'])}"
                  f" steps, checkpoint)", flush=True)
            expect_counts(f"pretrain CLI ({tag}, fused_minibatch auto)",
                          paths[f"pretrain_cli_{tag}"], {})
            mb_check_losses(f"pretrain CLI ({tag})", hist, steps)
            for part in ("encoder", "vq", "full"):
                if not os.path.exists(os.path.join(save_root,
                                                   f"{part}_{epoch}.npz")):
                    raise AssertionError(f"{part}_{epoch}.npz not written")
        print(f"  checkpoints {sorted(os.listdir(save_root))}", flush=True)

        argv = ["--finetune_dataset", DATASET, "--feat_dim", str(FEAT_DIM),
                "--pretrain_path", save_root, "--pretrain_model_epoch", "2",
                "--seed", str(SEED), "--epochs", str(MB_FT_EPOCHS),
                "--repeat", "1"]
        print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)}",
              flush=True)
        reset_counts()
        res = finetune_main(argv)
        paths["finetune_from_pretrain_cli"] = read_counts()
        expect_counts(f"finetune from the port's checkpoint ({MB_FT_EPOCHS} "
                      f"x (train step + eval))",
                      paths["finetune_from_pretrain_cli"],
                      {K2: MB_FT_EPOCHS * (3 + 2)})
        check_losses(res, MB_FT_EPOCHS)
        del res

        out = os.path.join(tmp, "mb_out.npz")
        argv = ["--finetune_dataset", DATASET, "--feat_dim", str(FEAT_DIM),
                "--pretrain_path", save_root, "--pretrain_model_epoch", "2",
                "--seed", str(SEED), "--out", out]
        print(f"  python -m stemgnn_tpu_torch.infer {' '.join(argv)}",
              flush=True)
        reset_counts()
        res = infer_main(argv)
        paths["encode_from_pretrain_cli"] = read_counts()
        expect_counts("encode from the port's checkpoint",
                      paths["encode_from_pretrain_cli"], {K2: 2})
        check_encode_outputs(out, res["num_nodes"])
        del res
    finally:
        if save_root is not None:
            remove_run_dir(save_root)

    argv = ["--finetune_dataset", DATASET, "--feat_dim", str(FEAT_DIM),
            "--seed", str(SEED), "--epochs", str(MB_FT_EPOCHS), "--repeat",
            "1"]
    print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)} (no "
          f"checkpoint: the codebook's k-means init)", flush=True)
    reset_counts()
    res = finetune_main(argv)
    paths["finetune_kmeans_init"] = read_counts()
    expect_counts(f"finetune with the k-means init (one eval-mode encode, "
                  f"{MB_FT_EPOCHS} x (train step + eval))",
                  paths["finetune_kmeans_init"],
                  {K2: 2 + MB_FT_EPOCHS * (3 + 2)})
    vq = res["model"].vq
    sizes = vq.cluster_size.sum(1).tolist()
    if not bool(vq.initted) or sizes != [float(ds.num_nodes)] * len(sizes):
        raise AssertionError(f"k-means init: initted {bool(vq.initted)}, "
                             f"bins sum to {sizes}")
    check_losses(res, MB_FT_EPOCHS)
    del res, vq


def pretrain_mb_run(ds, dev, paths):
    """``run_pretrain`` at full width on both routes, ``MB_STEPS`` steps
    each (module docstring, phase 9).  Returns the merged payload and its
    CSC graph (phase vq samples from them too)."""
    merged = merge_datasets([ds])
    node_table = torch.from_numpy(merged["node_text_feat"]).float().to(dev)
    edge_table = torch.from_numpy(merged["edge_text_feat"]).float().to(dev)
    csc = CSCGraph.from_edge_index(merged["edge_index"], ds.num_nodes)
    for route in ("auto", "on"):
        cfg = dataclasses.replace(pretrain_config(FEAT_DIM),
                                  batch_size=MB_BATCH, fanout=MB_FANOUT,
                                  fused_minibatch=route)
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        reset_counts()
        t0 = time.perf_counter()
        model, teacher, hist = run_pretrain(merged, cfg, weights=[1.0],
                                            max_steps=MB_STEPS, device=dev,
                                            verbose=False)
        paths[f"pretrain_mb_{route}"] = read_counts()
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        per_step = {K1: 3, K2: 2} if route == "on" else {}
        expect_counts(f"run_pretrain {route} ({MB_STEPS} steps)",
                      paths[f"pretrain_mb_{route}"],
                      {k: MB_STEPS * v for k, v in per_step.items()})
        rate = {k: v / MB_STEPS
                for k, v in paths[f"pretrain_mb_{route}"].items()}
        print(f"  {route}: launches a step {rate}", flush=True)
        mb_check_losses(f"run_pretrain {route}", hist, MB_STEPS)
        h = hist[0]

        # one batch of the loop, with its layout on the "on" route
        rng = np.random.default_rng(SEED + 1)
        it = NeighborBatchIterator(
            csc, merged["x"], merged["xe"],
            get_train_node_idx(merged["ptr"], [1.0], rng), MB_BATCH,
            [MB_FANOUT, MB_FANOUT], rng, drop_last=True)
        if not it._native:
            raise AssertionError("the sampler did not take the native route")
        ig = next(iter(it))[0]
        g = batch_graph(ig, node_table, edge_table, dev, route == "on")
        print(f"  {route}: batch of {ig.n_node} nodes / {ig.n_edge} edges, "
              f"padded {ig.num_nodes_padded} / {ig.num_edges_padded}"
              + ("" if g.layout is None else
                 f"; {describe_layout(g.layout)}"), flush=True)
        if route == "on":
            draws = draw_step(cfg, g, torch.Generator(device=dev)
                              .manual_seed(7))
            aug = augmented(cfg, g, draws)

            def grads(plain):
                m, t = copy.deepcopy(model), copy.deepcopy(teacher)
                loss, _, _ = pretrain_forward(
                    m, t, cfg, aug, g, bs=MB_BATCH, draws=draws,
                    drop_seed=draws["drop_seed"], plain=plain,
                    generator=torch.Generator(device=dev).manual_seed(7))
                loss.backward()
                return {k: p.grad for k, p in m.named_parameters()}
            reset_counts()
            g_kernel = grads(False)
            expect_counts("one minibatch forward + backward", read_counts(),
                          per_step)
            check_grads("the plain versions (minibatch, on)", g_kernel,
                        grads(True))
            del g_kernel, draws, aug
        opt = make_pretrain_optimizer(model, cfg)
        step = make_pretrain_step(cfg, MB_BATCH, generator=torch.Generator(
            device=dev).manual_seed(SEED))
        step_ms = cuda_ms(lambda: step(model, teacher, opt, g), 5)
        wall_ms = h["epoch_s"] * 1e3 / MB_STEPS
        print(f"  {route}: device {h['device_ms']:.3f} ms a step by CUDA "
              f"events in the loop, wall {wall_ms:.3f} ms a step over the "
              f"{MB_STEPS}-step epoch, idle share {h['idle']:.4f} (1 - the "
              f"steps' event time / the epoch's wall; run_pretrain "
              f"{run_s:.2f} s with its set-up); one batch alone "
              f"{step_ms:.3f} ms (CUDA events, mean of 5); host ms a batch: "
              f"sampler {h['host/sample_ms']:.3f}, layout build "
              f"{h.get('host/layout_ms', 0.0):.3f}, transfer + gather "
              f"{h['host/transfer_ms']:.3f}; peak device "
              f"memory {peak_gb:.2f} GB, {peak_gb - held_gb:.2f} GB above "
              f"the {held_gb:.2f} GB held before", flush=True)
        del model, teacher, opt, g
        torch.cuda.empty_cache()
    return merged, csc


def ood_run(tmp, dev, paths):
    """The five robustness evaluations (module docstring, phase 12): each
    script's ``main`` with its launches, JSON and times; the kernel-vs-plain
    checks on the edge-dropped and the missing-feature graphs."""
    mods = {"tri_objective": tri_objective,
            "random_edge_drop": random_edge_drop,
            "degree_shift_ood": degree_shift_ood,
            "homophily_shift_ood": homophily_shift_ood,
            "missing_feature": missing_feature}
    # the re-evaluations a run makes
    reevals = {"tri_objective": 4, "random_edge_drop": 1,
               "degree_shift_ood": 0, "homophily_shift_ood": 0,
               "missing_feature": 1}
    results = {}
    for name, mod in mods.items():
        results[name] = ood_script(name, mod, reevals[name], tmp, paths)
    ood_route_checks(results["random_edge_drop"], "edge-dropped", dev)
    # the missing-feature graph keeps the training graph's structure, so
    # its step makes the training path's kernel-2 launches
    k2 = ood_route_checks(results["tri_objective"],
                          "missing-feature (p = 0.8)", dev, time_k2=True)
    del results
    torch.cuda.empty_cache()
    return k2


def ood_script(name, mod, reevals, tmp, paths):
    """One evaluation script's ``main`` (``reevals`` re-evaluations a run):
    its launches, JSON, k-means init, TSV and times.  Returns its result."""
    argv = ["--finetune_dataset", OOD_DATASET, "--feat_dim",
            str(FEAT_DIM), "--seed", str(SEED), "--epochs", str(EPOCHS),
            "--runs", "1", "--debug", "--device", "cuda"]
    from_ckpt = name == "missing_feature"
    if from_ckpt:
        argv += ["--pretrain_path", tmp, "--pretrain_model_epoch", "50",
                 "--normalize", "batch", "--save_tsv", "1"]
    print(f"  python -m stemgnn_tpu_torch.scripts.{name} "
          f"{' '.join(argv)}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    reset_counts()
    t0 = time.perf_counter()
    res = mod.main(argv)
    paths[f"ood_{name}"] = read_counts()
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = (0 if from_ckpt else 2) + 5 * EPOCHS + 2 * reevals
    expect_counts(f"{name} ({'' if from_ckpt else 'k-means init, '}"
                  f"{EPOCHS} x (train step + eval), {reevals} "
                  f"re-evaluations)", paths[f"ood_{name}"], {K2: want})
    check_ood_payload(name, res["payload"])
    st, host = res["best"]["stats"], res["host_s"]
    if from_ckpt == ("kmeans_s" in st):
        raise AssertionError(f"{name}: k-means init "
                             f"{'ran' if from_ckpt else 'did not run'}")
    if from_ckpt and not any(f.endswith(".tsv") for f in os.listdir(tmp)):
        raise AssertionError("missing_feature wrote no TSV")
    layout_s = st["layout_s"]
    print(f"  {name}: wall {wall_s:.2f} s; host s: buckets "
          f"{host.get('buckets_s', 0.0):.3f}, perturbations "
          f"{['%.3f' % v for v in host.get('perturb_s', [])]}, layout "
          f"builds {['%.3f' % v for v in layout_s]} (training graph, "
          f"then each edge-dropped re-evaluation's), feature swaps "
          f"{['%.3f' % v for v in st.get('feat_swap_s', [])]} (each "
          f"missing-feature re-evaluation over the training layout), "
          f"k-means init "
          f"{st.get('kmeans_s', 0.0):.3f}; device ms (CUDA events): "
          f"steps {['%.3f' % v for v in st.get('step_ms', [])]}, evals "
          f"{['%.3f' % v for v in st.get('eval_ms', [])]}, "
          f"re-evaluations "
          f"{['%.3f' % v for v in st.get('reeval_ms', [])]}; peak "
          f"device memory {peak_gb:.2f} GB, {peak_gb - held_gb:.2f} GB "
          f"above the {held_gb:.2f} GB held before", flush=True)
    return res


def check_ood_payload(name, payload):
    """The JAX script's keys, and every accuracy of the run finite and in
    [0, 100]."""
    top, row_keys = OOD_KEYS[name]
    rows = payload["runs"]
    if list(payload) != top or len(rows) != 1 or list(rows[0]) != row_keys:
        raise AssertionError(f"{name}: keys {list(payload)} / "
                             f"{[list(r) for r in rows]} differ from the JAX "
                             f"script's {top} / {row_keys}")
    accs = {k: v for k, v in rows[0].items() if k != "best_epoch"}
    if not all(np.isfinite(v) and 0.0 <= v <= 100.0 for v in accs.values()):
        raise AssertionError(f"{name}: accuracies {accs}")
    print(f"  {name}: {json.dumps(accs)}; best epoch "
          f"{rows[0]['best_epoch']}", flush=True)


def ood_route_checks(res, what, dev, time_k2=False):
    """On the perturbed graph of a script's last re-evaluation, built again
    here (the same layout): the best snapshot's ``z`` through the kernels
    against the plain versions, and one training step's gradients.  With
    ``time_k2``, kernel 2's launches of that step are recorded, and its
    first forward and its backward launch checked against the plain version
    and timed (:func:`time_case`).  Returns {direction: (max_abs_err,
    times)}, empty without ``time_k2``."""
    best, cfg = res["best"], res["cfg"]
    t0 = time.perf_counter()
    graph = fused_full_graph(res["perturbed"], cfg, device=dev)
    torch.cuda.synchronize()
    print(f"  {what} graph: {res['perturbed'].num_edges} edges, layout "
          f"built in {time.perf_counter() - t0:.3f} s; "
          f"{describe_layout(graph.layout)}", flush=True)
    model = snapshot_model(best).eval()
    n = res["perturbed"].num_nodes
    with torch.no_grad():
        reset_counts()
        z = task_encode(model, graph)
        expect_counts(f"the snapshot's encode on the {what} graph",
                      read_counts(), {K2: 2})
        check_z(f"the plain versions on the {what} graph", z,
                task_encode(model, graph, plain=True), n)
    y = torch.from_numpy(best["y"]).to(dev)
    mask = torch.from_numpy(best["masks"]["train"]).to(dev)
    loss_fn = _make_node_steps(cfg)[0]
    reset_counts()
    calls = []
    real = fused_sage.gathered_scatter_rows_sorted

    def record(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    fused_sage.gathered_scatter_rows_sorted = record
    try:
        g_kernel = step_grads(model, loss_fn, mask, graph, y)
    finally:
        fused_sage.gathered_scatter_rows_sorted = real
    expect_counts(f"one training step on the {what} graph", read_counts(),
                  {K2: 3})
    check_grads(f"the plain versions on the {what} graph", g_kernel,
                step_grads(model, loss_fn, mask, graph, y, plain=True))
    out = {}
    cases = (("ood_fwd", calls[0]), ("ood_bwd", calls[-1])) if time_k2 else ()
    for direction, call in cases:
        out[direction] = launch_case(
            f"kernel 2 {direction} launch of the step on the {what} graph",
            K2, direction, call)
    del graph, model, g_kernel, calls
    return out


@contextlib.contextmanager
def shared_datasets():
    """Every phase's loads of one (name, width, seed, encoder, size) through
    the port's registry return one dataset object, generated or read once,
    and every full graph of such a dataset (``graph_setup.
    fused_full_graph``, per device and configuration of its layout) is
    built once: the entry points the smoke drives (the CLIs, the
    evaluation scripts) read their arrays and change none of them.  A
    relabelled or perturbed copy of a dataset gets its own graph, built
    where it is asked for.  Yields the graphs' cache (clear it to free
    their device memory)."""
    mods = (sys.modules[__name__], finetune_cli, infer_cli, pretrain_cli,
            scripts_common, ofa_tasks)
    real = registry.load_dataset
    sig = inspect.signature(real)
    loaded = {}
    graph_mods = (sys.modules[__name__], finetune_loop, pretrain_loop,
                  infer_cli, eval_runner)
    real_graph = graph_setup.fused_full_graph
    graph_sig = inspect.signature(real_graph)
    graphs = {}

    def graph_once(*a, **kw):
        bound = graph_sig.bind(*a, **kw)
        bound.apply_defaults()
        args = dict(bound.arguments)
        ds, cfg = args.pop("ds"), args.pop("cfg")
        if not any(ds is d for d in loaded.values()):
            return real_graph(*a, **kw)
        # what the build reads of the configuration
        key = json.dumps([id(ds), str(torch.device(args.pop("device"))),
                          cfg.encoder.backbone, cfg.use_fused_layout,
                          cfg.hub_size, cfg.sc_hub_size, cfg.reorder == "off",
                          sorted(args.items())], default=str)
        if key not in graphs:
            graphs[key] = real_graph(*a, **kw)
        return graphs[key]

    def load_once(*a, **kw):
        bound = sig.bind(*a, **kw)
        bound.apply_defaults()
        # every phase runs on the one card: the device names no other data
        key = json.dumps({k: v for k, v in bound.arguments.items()
                          if k != "device"}, sort_keys=True, default=str)
        if key not in loaded:
            t0 = time.perf_counter()
            loaded[key] = real(*a, **kw)
            print(f"  {bound.arguments['name']} loaded in "
                  f"{time.perf_counter() - t0:.2f} s (shared by every "
                  f"phase that loads it)", flush=True)
        return loaded[key]
    saved = [m.load_dataset for m in mods]
    saved_graph = [m.fused_full_graph for m in graph_mods]
    for m in mods:
        m.load_dataset = load_once
    for m in graph_mods:
        m.fused_full_graph = graph_once
    try:
        yield graphs
    finally:
        for m, f in zip(mods, saved):
            m.load_dataset = f
        for m, f in zip(graph_mods, saved_graph):
            m.fused_full_graph = f
        graphs.clear()


def kg_describe(name, res):
    g = res["graph"]
    print(f"  {name}: {g.n_node} entities, {g.n_edge} edges, "
          f"{res['cfg'].num_classes} relation classes; "
          f"{describe_layout(g.layout)}", flush=True)


def kg_run(tmp, dev, paths):
    """The knowledge-graph link presets (module docstring, phase 13).
    Returns kernel 2's check and times at the WN18RR evaluation's first
    launch."""
    base = ["--use_params", "--repeat", "1", "--seed", str(SEED),
            "--debug"]
    # WN18RR: the full-batch preset
    argv = ["--finetune_dataset", "WN18RR", "--epochs", str(EPOCHS), *base]
    print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = finetune_main(argv)
    paths["kg_wn18rr"] = read_counts()
    wall_s = time.perf_counter() - t0
    kg_describe("WN18RR", res)
    expect_counts(f"WN18RR (k-means init, {EPOCHS} x (train step + eval))",
                  paths["kg_wn18rr"], {K2: 2 + EPOCHS * (3 + 2)})
    check_losses(res)
    model, g, y, mask = res["model"], res["graph"], res["y"], res[
        "train_mask"]
    init = res["init_params"]
    for name, p in model.named_parameters():
        same = torch.equal(p.detach().cpu(), init[name])
        if same != name.startswith("vq."):
            raise AssertionError(f"{name} {'did not move' if same else 'moved'}")
    print("  every encoder parameter and the decoder moved; the frozen VQ "
          "did not", flush=True)
    loss_fn, train_step, eval_step = res["steps"]
    reset_counts()
    g_kernel = step_grads(model, loss_fn, mask, g, y)
    expect_counts("one WN18RR training step", read_counts(), {K2: 3})
    check_grads("the plain versions (WN18RR)", g_kernel,
                step_grads(model, loss_fn, mask, g, y, plain=True))
    del g_kernel
    calls = []
    real = fused_sage.gathered_scatter_rows_sorted

    def record(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    reset_counts()
    fused_sage.gathered_scatter_rows_sorted = record
    try:
        eval_step(model, g)
    finally:
        fused_sage.gathered_scatter_rows_sorted = real
    expect_counts("one WN18RR evaluation", read_counts(), {K2: 2})
    with torch.no_grad():
        model.eval()
        check_z("the plain versions (WN18RR)", task_encode(model, g),
                task_encode(model, g, plain=True), g.n_node)
    opt = torch.optim.AdamW([p for p in model.parameters()
                             if p.requires_grad], lr=1e-3, weight_decay=0.01)
    gen = torch.Generator(device=dev).manual_seed(0)
    step_ms = cuda_ms(lambda: train_step(model, opt, mask, g, y, gen), 5)
    eval_ms = cuda_ms(lambda: eval_step(model, g), 5)
    print(f"  WN18RR: finetune wall {wall_s:.2f} s with its set-up; "
          f"training step {step_ms:.3f} ms, evaluation {eval_ms:.3f} ms, by "
          f"CUDA events; per-epoch wall "
          f"{['%.3f' % v for v in res['epoch_s']]} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    k2_kg = launch_case("kernel 2 at the WN18RR evaluation's first launch",
                        K2, "kg_eval", calls[0])
    del res, model, g, opt, calls
    torch.cuda.empty_cache()

    # FB15K237: the minibatch preset, the export and its predictions
    model_path = os.path.join(tmp, "fb15k237_task.npz")
    argv = ["--finetune_dataset", "FB15K237", "--epochs", "2", *base,
            "--save_model", model_path]
    print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)}",
          flush=True)
    reset_counts()
    t0 = time.perf_counter()
    res = finetune_main(argv)
    paths["kg_fb15k237"] = read_counts()
    wall_s = time.perf_counter() - t0
    kg_describe("FB15K237", res)
    expect_counts("FB15K237 (k-means init, 2 x (minibatch epoch + eval))",
                  paths["kg_fb15k237"], {K2: 2 + 2 * 2})
    check_losses(res, 2)
    for e, h in enumerate(res["history"]):
        print(f"  FB15K237 epoch {e}: {h['batches']} batches of 1024 "
              f"edges; host ms a batch: sampler {h['host/sample_ms']:.3f}, "
              f"copies + gather {h['host/transfer_ms']:.3f}; batch step "
              f"{h['device_ms']:.3f} ms device (CUDA events), idle share "
              f"{h['idle']:.4f} of the epoch's {h['epoch_s']:.3f} s; "
              f"evaluation {h['eval_ms']:.3f} ms", flush=True)
    print(f"  FB15K237: finetune wall {wall_s:.2f} s with its set-up",
          flush=True)
    fb_graph, fb_eval, best_pred = (res["graph"], res["steps"][2],
                                    res["best_pred"])
    del res

    out = os.path.join(tmp, "fb15k237_pred.npz")
    argv = ["--mode", "predict", "--finetune_dataset", "FB15K237",
            "--model", model_path, "--out", out]
    print(f"  python -m stemgnn_tpu_torch.infer {' '.join(argv)}",
          flush=True)
    reset_counts()
    pres = infer_main(argv)
    paths["kg_predict"] = read_counts()
    expect_counts("infer --mode predict (one evaluation)",
                  paths["kg_predict"], {K2: 2})
    got = np.load(out)
    probs, pred = got["probs"], got["pred"]
    n_e = fb_graph.n_edge
    if probs.shape != (38_001, 228) or n_e != 38_001:
        raise AssertionError(f"probs {probs.shape} over {n_e} edges")
    sums = probs.sum(1)
    if not np.allclose(sums, 1.0, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"probability rows sum to {sums.min()}.."
                             f"{sums.max()}")
    want = best_pred[:n_e]
    if not np.array_equal(pred, want.argmax(-1)):
        raise AssertionError("--mode predict disagrees with the best "
                             "epoch's evaluation")
    print(f"  predictions of {n_e} edges equal the best epoch's evaluation; "
          f"probabilities max_abs_err {np.abs(probs - want).max():.3e}, "
          f"rows sum to 1 within {np.abs(sums - 1).max():.1e}", flush=True)
    del pres

    # one epoch with the layer-wise chunked evaluation
    argv = ["--finetune_dataset", "FB15K237", "--epochs", "1", *base,
            "--eval_chunked", "1"]
    print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)}",
          flush=True)
    reset_counts()
    res = finetune_main(argv)
    paths["kg_chunked"] = read_counts()
    expect_counts("FB15K237 with the chunked evaluation (graph-free k-means "
                  "init, 1 x (minibatch epoch + layer-wise eval))",
                  paths["kg_chunked"], {})
    check_losses(res, 1)
    if res["graph"] is not None:
        raise AssertionError("the chunked evaluation built the full graph")
    model = res["model"].eval()
    ds = load_dataset("FB15K237", feat_dim=FEAT_DIM, seed=SEED)
    t0 = time.perf_counter()
    chunked = layerwise_eval_predict(model, res["cfg"], ds, "link",
                                     fb_graph.num_edges_padded,
                                     device=dev)[:n_e]
    lw_s = time.perf_counter() - t0
    z_lw, _ = layerwise_encode(
        model.encoder, ds.node_features(), ds.edge_index[0],
        ds.edge_index[1], xe=ds.xe, edge_table=ds.edge_text_feat,
        num_nodes=ds.num_nodes, device=dev)
    reset_counts()
    with torch.no_grad():
        z_fused = task_encode(model, fb_graph)
        fused = fb_eval(model, fb_graph)[:n_e].cpu().numpy()
    expect_counts("the fused encode and evaluation of the chunked run's "
                  "model", read_counts(), {K2: 2 + 2})
    check_z("the fused encode (layer-wise, FB15K237)", z_lw, z_fused,
            ds.num_nodes)
    with torch.no_grad():
        codes_lw = model.vq(z_lw[:ds.num_nodes])["indices"]
        codes_f = model.vq(z_fused[:ds.num_nodes])["indices"]
    s_, r_ = (torch.from_numpy(np.asarray(a)).to(dev) for a in ds.edge_index)
    same = ((codes_lw[s_] == codes_f[s_]).all(1)
            & (codes_lw[r_] == codes_f[r_]).all(1)).cpu().numpy()
    check_close("chunked vs fused probabilities (edges whose endpoints keep "
                "their codes)", torch.from_numpy(chunked[same]),
                torch.from_numpy(fused[same]), Z_RTOL, Z_ATOL,
                what="the chunked evaluation")
    agree = float((chunked.argmax(-1) == fused.argmax(-1)).mean())
    print(f"  chunked evaluation {lw_s:.3f} s; {same.mean():.4f} of the "
          f"edges keep every code on both routes; predictions equal on "
          f"{agree:.4f} of the edges", flush=True)
    if same.mean() < 0.9:
        raise AssertionError(f"only {same.mean():.4f} of the edges keep "
                             f"their codes")
    del res, model, fb_graph, z_lw, z_fused
    torch.cuda.empty_cache()
    return k2_kg


def graph_history(tag, res):
    """Print each epoch of a graph-task run's history."""
    for e, h in enumerate(res["history"]):
        ev = ""
        if "eval_ms" in h:
            ev = ("; evaluation " + ", ".join(
                f"{k} {h[f'eval_ms/{k}']:.3f}" for k in ("train", "valid",
                                                         "test")
                if f"eval_ms/{k}" in h)
                + f" ms device ({h['eval_route']}), {h['eval_s']:.3f} s wall")
        print(f"  {tag} epoch {e}: {h['batches']} batches; host ms a batch: "
              f"build {h['host/sample_ms']:.3f}, copies + gather "
              f"{h['host/transfer_ms']:.3f}; step {h['device_ms']:.3f} ms "
              f"device (CUDA events), idle share {h['idle']:.4f} of the "
              f"epoch's {h['epoch_s']:.3f} s{ev}", flush=True)
    b = res["logger"].get_single_best(0)
    print(f"  {tag}: best epoch {b['epoch']}: AUC train {b['train']:.2f}, "
          f"valid {b['val']:.2f}, test {b['test']:.2f}", flush=True)
    for k in ("train", "val", "test"):
        if not 0.0 <= b[k] <= 100.0:
            raise AssertionError(f"{tag}: {k} AUC {b[k]}")


def code_gaps(model, graphs, ids, to_device, bs):
    """For the molecules ``ids`` (batched on their own), the smallest over
    the heads of the gap between the similarities of the two codes nearest
    to the pooled embedding: where it is within float noise of 0, another
    batching may pick the other code."""
    vq = model.vq
    dummy = np.zeros((len(graphs), 1))
    gaps = []
    model.eval()
    with torch.no_grad():
        for g, _, n in _batch_graph_list(graphs, dummy, ids, bs):
            g = to_device(g)
            pooled = pool_graph(task_encode(model, g), g, "mean", bs)[:n]
            xp = vq.project_in(pooled) if vq.cfg.requires_projection \
                else pooled
            xh = vq._to_heads(xp).float()
            if vq.cfg.use_cosine_sim:
                sim = cb.cosine_distances(cb.l2norm(xh), vq.embed)
            else:
                sim = cb.euclidean_distances(xh, vq.embed)
            top = sim.topk(2, dim=-1).values
            gaps.append((top[..., 0] - top[..., 1]).min(0).values)
    return torch.cat(gaps).cpu().numpy()


def check_device_auc(res, labels, split, dev):
    """The AUC of each split of the saved best evaluation's predictions on
    the card (``device_multitask_auc``) against the host's (1e-6) and the
    logged one."""
    best, best_pred = res["logger"].get_single_best(0), res["best_pred"]
    for k, key in (("train", "train"), ("valid", "val"), ("test", "test")):
        rows = np.where(split[k])[0]
        y = labels[rows]
        pred = torch.from_numpy(best_pred[k]).to(dev)
        dev_auc = float(device_multitask_auc(
            pred, torch.from_numpy(np.nan_to_num(y).astype(np.float32)).to(
                dev), torch.from_numpy(~np.isnan(y)).to(dev)))
        host_auc = eval_auc(best_pred[k], y)
        print(f"  {k}: AUC on the card {dev_auc:.9f}, on the host "
              f"{host_auc:.9f} (difference {abs(dev_auc - host_auc):.2e}, "
              f"tolerance 1e-6); logged {best[key]:.6f}", flush=True)
        if not abs(dev_auc - host_auc) <= 1e-6 or \
                not abs(dev_auc * 100 - best[key]) <= 1e-4:
            raise AssertionError(f"{k}: device AUC {dev_auc}, host AUC "
                                 f"{host_auc}, logged {best[key]}")


def graph_run(tmp, dev, paths):
    """The graph tasks (module docstring, phase 14)."""
    torch.cuda.reset_peak_memory_stats()
    base = ["--repeat", "1", "--seed", str(SEED), "--debug"]
    # (a) the mol_synthetic preset: the materialized bundle, the host AUC
    argv = ["--use_params", "--finetune_dataset", "mol_synthetic",
            "--epochs", "2", *base]
    print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)}",
          flush=True)
    reset_counts()
    t0 = time.perf_counter()
    res = finetune_main(argv)
    paths["graph_mol_synthetic"] = read_counts()
    print(f"  mol_synthetic: finetune wall {time.perf_counter() - t0:.2f} s "
          f"with its set-up", flush=True)
    expect_counts("mol_synthetic (k-means init, 2 x (epoch + evaluation))",
                  paths["graph_mol_synthetic"], {})
    check_losses(res, 2)
    if not res["eval_route"].startswith("host AUC, cached"):
        raise AssertionError(f"mol_synthetic evaluated by {res['eval_route']}")
    graph_history("mol_synthetic", res)
    del res

    # (b) an indexed bundle of generated molecules with chemhiv's preset
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "chip_smoke_molecules.csv")
    t0 = time.perf_counter()
    write_smiles_csv(csv_path, MOLECULES, num_tasks=MOL_TASKS, seed=SEED)
    gen_s = time.perf_counter() - t0
    name = f"smiles:{csv_path}"
    t0 = time.perf_counter()
    graphs, labels, split = load_dataset(name, feat_dim=FEAT_DIM, seed=SEED)
    feat_s = time.perf_counter() - t0
    n_atoms = sum(len(g["x"]) for g in graphs)
    print(f"  {MOLECULES} molecules generated in {gen_s:.2f} s and parsed "
          f"and featurized in {feat_s:.2f} s on the host: "
          f"{n_atoms / MOLECULES:.2f} heavy atoms a molecule, "
          f"node table {graphs.node_table.shape}, edge table "
          f"{graphs.edge_table.shape}, {labels.shape[1]} tasks, "
          f"{np.isnan(labels).mean():.3f} NaN; split "
          f"{[int(split[k].sum()) for k in ('train', 'valid', 'test')]}",
          flush=True)
    model_path = os.path.join(tmp, "molecules_task.npz")
    argv = ["--finetune_dataset", name, "--batch_size", "1024", "--lr",
            "3e-4", "--normalize", "batch", "--early_stop", "20",
            "--epochs", "2", *base, "--save_model", model_path]
    print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)}",
          flush=True)
    reset_counts()
    t0 = time.perf_counter()
    res = finetune_main(argv)
    paths["graph_molecules"] = read_counts()
    print(f"  {MOLECULES} molecules: finetune wall "
          f"{time.perf_counter() - t0:.2f} s with its set-up", flush=True)
    expect_counts("molecules (k-means init, 2 x (epoch + evaluation))",
                  paths["graph_molecules"], {})
    check_losses(res, 2)
    if not res["eval_route"].startswith("device AUC"):
        raise AssertionError(f"the indexed bundle evaluated by "
                             f"{res['eval_route']}")
    graph_history(f"{MOLECULES} molecules", res)

    # the device AUC against the host AUC over the run's own predictions
    check_device_auc(res, labels, split, dev)
    best_pred = res["best_pred"]

    # a training step's gradients against the plain route
    loss_fn, to_device = res["steps"][0], res["to_device"]
    g, lab, n = next(_batch_graph_list(graphs, labels,
                                       np.where(split["train"])[0], 1024))
    g = to_device(g)
    y = torch.from_numpy(np.nan_to_num(lab * 2.0 - 1.0).astype(
        np.float32)).to(dev)
    valid = torch.from_numpy(~np.isnan(lab)).to(dev)
    gmask = torch.arange(1024, device=dev) < n

    def grads(plain):
        m = copy.deepcopy(res["model"])
        gen = torch.Generator(device=dev).manual_seed(7)
        loss, _ = loss_fn(m, g, y, valid, gmask, gen, plain)
        loss.backward()
        return {k: p.grad for k, p in m.named_parameters()
                if p.requires_grad and p.grad is not None}
    reset_counts()
    g_default = grads(False)
    expect_counts("one graph training step", read_counts(), {})
    check_grads("the plain versions (graph step)", g_default, grads(True))
    del g_default, res

    # --mode predict on the saved model: the best evaluation's logits
    out = os.path.join(tmp, "molecules_pred.npz")
    argv = ["--mode", "predict", "--finetune_dataset", name, "--model",
            model_path, "--out", out]
    print(f"  python -m stemgnn_tpu_torch.infer {' '.join(argv)}",
          flush=True)
    reset_counts()
    t0 = time.perf_counter()
    pres = infer_main(argv)
    paths["graph_predict"] = read_counts()
    print(f"  predict wall {time.perf_counter() - t0:.2f} s", flush=True)
    expect_counts("infer --mode predict", paths["graph_predict"], {})
    probs = np.load(out)["probs"]
    if probs.shape != (MOLECULES, MOL_TASKS) or not np.isfinite(
            probs).all():
        raise AssertionError(f"probs {probs.shape}")
    flipped, worst = [], 0.0
    for k, logits in best_pred.items():
        rows = np.where(split[k])[0]
        err = np.abs(probs[rows] - 1.0 / (1.0 + np.exp(-logits))).max(1)
        flipped.extend(rows[err > 1e-6])
        worst = max(worst, float(err[err <= 1e-6].max(initial=0.0)))
    print(f"  predictions of {MOLECULES} molecules against the best "
          f"evaluation's sigmoid: max_abs_err {worst:.3e} (tolerance 1e-6) "
          f"on all but {len(flipped)} molecules", flush=True)
    if flipped:
        gaps = code_gaps(pres["model"], graphs, np.asarray(flipped),
                         _graph_feeder(graphs, dev)[1], 1024)
        print(f"  the {len(flipped)} others sit at a near-tie of two VQ "
              f"codes (the largest gap {gaps.max():.2e}), where the "
              f"batching's float noise picks the other code", flush=True)
        if gaps.max() > 1e-5 or len(flipped) > MOLECULES // 1000:
            raise AssertionError("--mode predict disagrees with the best "
                                 "evaluation")
    del pres

    # --mode encode from phase slice's pretrain checkpoint
    out = os.path.join(tmp, "molecules_enc.npz")
    argv = ["--finetune_dataset", name, "--pretrain_path", tmp,
            "--pretrain_model_epoch", "50", "--out", out]
    print(f"  python -m stemgnn_tpu_torch.infer {' '.join(argv)}",
          flush=True)
    reset_counts()
    t0 = time.perf_counter()
    infer_main(argv)
    paths["graph_encode"] = read_counts()
    print(f"  encode wall {time.perf_counter() - t0:.2f} s", flush=True)
    expect_counts("infer --mode encode", paths["graph_encode"], {})
    got = np.load(out)
    want = {"embeddings": (MOLECULES, FEAT_DIM),
            "quantized": (MOLECULES, FEAT_DIM), "codes": (MOLECULES, 4)}
    shapes = {k: got[k].shape for k in got.files}
    if shapes != want or not all(np.isfinite(got[k]).all()
                                 for k in ("embeddings", "quantized")):
        raise AssertionError(f"encode outputs {shapes}")
    codes = got["codes"]
    if codes.min() < 0 or codes.max() >= 128:
        raise AssertionError(f"codes {codes.min()}..{codes.max()}")
    print(f"  encode outputs {shapes}, {len(np.unique(codes, axis=0))} "
          f"distinct code rows; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB in the phase",
          flush=True)


class Bf16Launches:
    """Inside the ``with``: the kernel names ``ops.fused_sage`` calls are
    wrapped to keep the arguments of the first launch of each kernel (and
    of kernel 2's ``xe`` mode) whose output is bf16, for checking that
    launch against its plain version afterwards; every call goes on to the
    kernel unchanged, so the launch counts are the kernels' own."""

    NAMES = (K1, K2, K3)

    def __init__(self):
        self.first = {}

    def __enter__(self):
        self.saved = {n: getattr(fused_sage, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(fused_sage, n, self._wrap(n, fn))
        return self

    def _wrap(self, name, fn):
        def wrapped(*a, **kw):
            if kw.get("out_dtype") == torch.bfloat16:
                xe = name == K2 and len(a) > 5 and a[5] is not None
                self.first.setdefault(name + (":xe" if xe else ""), (a, kw))
            return fn(*a, **kw)
        return wrapped

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(fused_sage, n, fn)
        return False

    def need(self, *keys):
        missing = [k for k in keys if k not in self.first]
        if missing:
            raise AssertionError(f"no bf16-output launch of {missing}; "
                                 f"seen {sorted(self.first)}")


def check_mp_losses(tag, got, want):
    """The JAX package's mixed-precision gate
    (tests/test_end_to_end.py:188-190): each loss within 2% of the f32
    one, or of 0.1 for a small one."""
    worst = 0.0
    for k in MP_LOSSES:
        a, b = float(got[k]), float(want[k])
        worst = max(worst, abs(a - b) / max(abs(b), 0.1))
        print(f"  {tag} {k}: {a:.6f} against f32 {b:.6f}", flush=True)
    print(f"  {tag}: worst deviation {worst:.4%} of the f32 losses "
          f"(gate 2%)", flush=True)
    if worst > 0.02:
        raise AssertionError(f"{tag}: the losses leave the 2% gate")
    return worst


def mp_step_run(graph, dev, paths, cases):
    """(a) The full-graph pretrain step under ``pretrain.py
    --mixed_precision`` on phase pretrain's graph and layout
    (``MP_STEPS`` steps at full width)."""
    cfg = pretrain_config(FEAT_DIM, mixed_precision=True)
    model = PretrainModel(
        cfg, generator=torch.Generator().manual_seed(SEED)).to(dev)
    teacher = make_teacher(model)
    opt = make_pretrain_optimizer(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bs = graph.num_nodes_padded
    step = make_pretrain_step(cfg, bs, generator=gen)
    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    with Bf16Launches() as cap:
        reset_counts()
        losses = [{k: float(v) for k, v in step(model, teacher, opt, graph)
                   .items()} for _ in range(MP_STEPS)]
        paths["mp_pretrain"] = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect_counts(f"mixed-precision pretrain ({MP_STEPS} steps)",
                  paths["mp_pretrain"], {K1: 3 * MP_STEPS,
                                         K2: 2 * MP_STEPS})
    for i, ls in enumerate(losses):
        print(f"  step {i}: " + ", ".join(f"{k} {v:.6f}"
                                          for k, v in ls.items()),
              flush=True)
    totals = [ls["loss"] for ls in losses]
    if not all(np.isfinite(v) for ls in losses for v in ls.values()) \
            or len(set(totals)) == 1:
        raise AssertionError(f"mixed-precision losses {losses}")
    if any(torch.equal(a, b) for a, b in zip(before, model.parameters())) \
            or any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError("a parameter did not move or is not f32")
    print(f"  every parameter moved and stays f32; peak device memory "
          f"{peak_gb:.2f} GB, {peak_gb - held_gb:.2f} GB above the "
          f"{held_gb:.2f} GB held before", flush=True)
    cap.need(K1, K2)
    for name, case in ((K1, "mp_drop_fwd"), (K2, "mp_teacher")):
        cases[(name, case)] = launch_case(
            f"mixed-precision step: the first bf16-output launch of {name}",
            name, case, cap.first[name])
    del cap

    # the losses against the f32 forward on the same parameters and draws,
    # with cuBLAS's bf16 split-K reductions allowed (the default) and not
    draws = draw_step(cfg, graph, torch.Generator(device=dev).manual_seed(7))
    aug = augmented(cfg, graph, draws)

    def forward(c, plain=False):
        m, t = copy.deepcopy(model), copy.deepcopy(teacher)
        loss, ls, _ = pretrain_forward(
            m, t, c, aug, graph, bs=bs, draws=draws,
            drop_seed=draws["drop_seed"], plain=plain,
            generator=torch.Generator(device=dev).manual_seed(7))
        return m, loss, ls
    with torch.no_grad():
        want = forward(pretrain_config(FEAT_DIM))[2]
        matmul = torch.backends.cuda.matmul
        reduced = matmul.allow_bf16_reduced_precision_reduction
        devs = {}
        try:
            for flag in (True, False):
                matmul.allow_bf16_reduced_precision_reduction = flag
                devs[flag] = check_mp_losses(
                    f"mp (bf16 reduced-precision reductions "
                    f"{'allowed' if flag else 'off'})", forward(cfg)[2],
                    want)
        finally:
            matmul.allow_bf16_reduced_precision_reduction = reduced

    def grads(plain):
        m, loss, _ = forward(cfg, plain)
        loss.backward()
        return {k: p.grad for k, p in m.named_parameters()}
    reset_counts()
    g_kernel = grads(False)
    expect_counts("one mixed-precision forward + backward", read_counts(),
                  {K1: 3, K2: 2})
    if any(g.dtype != torch.float32 for g in g_kernel.values()):
        raise AssertionError("a master gradient is not f32")
    check_grads("the plain versions (mixed precision)", g_kernel,
                grads(True))
    del g_kernel, draws, aug

    step_ms = cuda_ms(lambda: step(model, teacher, opt, graph), 3)
    stages = stage_ms(cfg, model, teacher, opt, graph, gen, bs, 3)
    print(f"  mixed-precision pretrain step {step_ms:.3f} ms by CUDA events "
          f"(mean of 3); stages (mean of 3): " + ", ".join(
              f"{s} {ms:.3f} ms" for s, ms in zip(STAGES, stages)),
          flush=True)
    del model, teacher, opt
    torch.cuda.empty_cache()


def mp_minibatch_run(ds, dev, paths):
    """(b) ``python -m stemgnn_tpu_torch.pretrain --mixed_precision`` for
    ``MP_MB_STEPS`` minibatch steps (``fused_minibatch="auto"``: no kernel),
    then the CLI's config on ``"on"`` through ``run_pretrain`` (kernel 1 x
    3 and kernel 2 x 2 a step, bf16 outputs)."""
    run_id = f"chip_smoke_mp_{os.getpid()}"
    argv = ["--pretrain_dataset", DATASET, "--feat_dim", str(FEAT_DIM),
            "--seed", str(SEED), "--pretrain_run_id", run_id, "--epochs",
            "1", "--max_steps", str(MP_MB_STEPS), "--mixed_precision"]
    print(f"  python -m stemgnn_tpu_torch.pretrain {' '.join(argv)}",
          flush=True)
    save_root = None
    try:
        reset_counts()
        t0 = time.perf_counter()
        _, _, hist, save_root = pretrain_cli.main(argv)
        paths["mp_pretrain_cli_auto"] = read_counts()
        print(f"  wall {time.perf_counter() - t0:.2f} s (dataset, sampler "
              f"set-up, {MP_MB_STEPS} steps, checkpoint)", flush=True)
    finally:
        if save_root is not None:
            remove_run_dir(save_root)
    expect_counts("mixed-precision pretrain CLI (fused_minibatch auto)",
                  paths["mp_pretrain_cli_auto"], {})
    mb_check_losses("mixed-precision pretrain CLI (auto)", hist, MP_MB_STEPS)
    auto = hist[0]
    cfg = dataclasses.replace(
        pretrain_cli.make_config(pretrain_cli.parse(argv)),
        fused_minibatch="on")
    reset_counts()
    _, _, hist = run_pretrain(merge_datasets([ds]), cfg, weights=[1.0],
                              max_steps=MP_MB_STEPS, device=dev,
                              verbose=False)
    paths["mp_pretrain_mb_on"] = read_counts()
    expect_counts(f"mixed-precision run_pretrain on ({MP_MB_STEPS} steps)",
                  paths["mp_pretrain_mb_on"],
                  {K1: 3 * MP_MB_STEPS, K2: 2 * MP_MB_STEPS})
    mb_check_losses("mixed-precision run_pretrain (on)", hist, MP_MB_STEPS)
    for tag, h in (("auto", auto), ("on", hist[0])):
        print(f"  {tag}: device {h['device_ms']:.3f} ms a step by CUDA "
              f"events in the loop, wall "
              f"{1e3 * h['epoch_s'] / MP_MB_STEPS:.3f} ms a step, idle share "
              f"{h['idle']:.4f}; host ms a batch: sampler "
              f"{h['host/sample_ms']:.3f}, layout build "
              f"{h.get('host/layout_ms', 0.0):.3f} (the first step's "
              f"warm-up included)", flush=True)


def mp_finetune_run(tmp, dev, paths, cases):
    """(c) ``finetune --bf16``: the node full batch for ``EPOCHS`` epochs
    from phase slice's checkpoint (kernel 2 with bf16 out, 3 a step and 2
    an evaluation) and the typed link finetune on ``kg_synthetic`` (kernel
    3 once a step, kernel 2's ``xe`` mode twice a step and an evaluation,
    bf16 outputs); ``z`` and one training step's gradients through the
    kernels against the plain route."""
    base = ["--feat_dim", str(FEAT_DIM), "--pretrain_path", tmp,
            "--pretrain_model_epoch", "50", "--seed", str(SEED), "--epochs",
            str(EPOCHS), "--repeat", "1", "--bf16"]
    for tag, name, want, per_step, keys in (
            ("node", DATASET, {K2: EPOCHS * (3 + 2)}, {K2: 3}, (K2,)),
            ("link", KG, {K2: EPOCHS * (2 + 2), K3: EPOCHS}, {K2: 2, K3: 1},
             (f"{K2}:xe", K3))):
        argv = ["--finetune_dataset", name, *base]
        print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)}",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        with Bf16Launches() as cap:
            reset_counts()
            t0 = time.perf_counter()
            res = finetune_main(argv)
            paths[f"mp_finetune_{tag}"] = read_counts()
        print(f"  {tag}: wall {time.perf_counter() - t0:.2f} s; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)
        expect_counts(f"finetune --bf16 {tag} ({EPOCHS} x (train step + "
                      f"eval))", paths[f"mp_finetune_{tag}"], want)
        check_losses(res)
        cap.need(*keys)
        for key in keys:
            case = {K2: "bf16_node", f"{K2}:xe": "bf16_xe",
                    K3: "bf16_link"}[key]
            cases[(key.split(":")[0], case)] = launch_case(
                f"finetune --bf16 {tag}: the first bf16-output launch of "
                f"{key}", key.split(":")[0], case, cap.first[key])
        del cap
        model, g = res["model"], res["graph"]
        model.eval()
        with torch.no_grad():
            z = task_encode(model, g)
            if z.dtype != torch.bfloat16:
                raise AssertionError(f"--bf16 gave a {z.dtype} z")
            n = g.n_node if isinstance(g.n_node, int) else int(g.n_node)
            check_z(f"the plain route (--bf16 {tag})", z,
                    task_encode(model, g, plain=True), n)
        loss_fn, train_step, _ = res["steps"]
        reset_counts()
        g_kernel = step_grads(model, loss_fn, res["train_mask"], g, res["y"])
        expect_counts(f"one --bf16 {tag} training step", read_counts(),
                      per_step)
        check_grads(f"the plain versions (--bf16 {tag})", g_kernel,
                    step_grads(model, loss_fn, res["train_mask"], g,
                               res["y"], plain=True))
        del g_kernel
        opt = torch.optim.AdamW([p for p in model.parameters()
                                 if p.requires_grad], lr=1e-3)
        gen = torch.Generator(device=dev).manual_seed(0)
        step_ms = cuda_ms(lambda: train_step(model, opt, res["train_mask"],
                                             g, res["y"], gen), 5)
        print(f"  {tag}: --bf16 training step {step_ms:.3f} ms by CUDA "
              f"events (mean of 5)", flush=True)
        del res, model, g, opt
        torch.cuda.empty_cache()


def mp_graph_run(tmp, dev, paths):
    """(d) The graph task on ``mol_synthetic`` (its preset, 2 epochs) with
    ``--bf16`` and with ``--eval_bf16 1``: no kernel (a molecule batch has
    no layout), finite losses, the evaluation's ``z`` bf16, the device AUC
    of the saved best predictions against the host AUC (1e-6)."""
    graphs, labels, split = load_dataset("mol_synthetic", feat_dim=FEAT_DIM,
                                         seed=SEED)
    for tag, flags in (("bf16", ["--bf16"]),
                       ("eval_bf16", ["--eval_bf16", "1"])):
        model_path = os.path.join(tmp, f"mp_graph_{tag}.npz")
        argv = ["--use_params", "--finetune_dataset", "mol_synthetic",
                "--epochs", "2", "--repeat", "1", "--seed", str(SEED),
                "--debug", "--save_model", model_path, *flags]
        print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)}",
              flush=True)
        seen = set()
        real = finetune_loop.encode

        def encode_rec(model, g, **kw):
            z = real(model, g, **kw)
            if not model.training:
                seen.add(z.dtype)
            return z
        finetune_loop.encode = encode_rec
        try:
            reset_counts()
            res = finetune_main(argv)
            paths[f"mp_graph_{tag}"] = read_counts()
        finally:
            finetune_loop.encode = real
            if os.path.exists(model_path):
                os.remove(model_path)
        expect_counts(f"mol_synthetic {tag}", paths[f"mp_graph_{tag}"], {})
        check_losses(res, 2)
        if seen != {torch.bfloat16}:
            raise AssertionError(f"{tag}: the evaluation ran in {seen}")
        graph_history(f"mol_synthetic {tag}", res)
        check_device_auc(res, labels, split, dev)
        del res


MOE_FLAGS = ["--moe", "--moe_layers", "last", "--lamda_env", "0.1"]


class MoELines:
    """Counts the finetune loop's ``[MoE]`` usage printouts (one call
    prints a line an MoE layer)."""

    def __init__(self):
        self.calls, self.real = 0, finetune_loop.print_moe_usage

    def __enter__(self):
        def counted(stats):
            self.calls += 1
            return self.real(stats)
        finetune_loop.print_moe_usage = counted
        return self

    def __exit__(self, *exc):
        finetune_loop.print_moe_usage = self.real
        return False


def bb_finetune(tag, argv, paths, want, epochs):
    """One ``finetune.main`` run of phase backbones: its launches
    (``want``), finite losses, the ``[MoE]`` printouts, peak memory, and
    the last epoch's training step and evaluation ms (CUDA events recorded
    in the loop: ``history``).  Returns the CLI's result."""
    print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)}",
          flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    reset_counts()
    t0 = time.perf_counter()
    with MoELines() as lines:
        res = finetune_main(argv)
    paths[tag] = read_counts()
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect_counts(f"{tag} ({epochs} x (train step + eval))", paths[tag],
                  want)
    check_losses(res, epochs)
    moe = any(res["cfg"].encoder.moe_layer_flags())
    env = [e["env_loss"] for e in res["epoch_losses"]]
    if moe != all(v < 0 for v in env) or lines.calls != (epochs if moe
                                                         else 0):
        raise AssertionError(f"{tag}: env_loss {env}, {lines.calls} [MoE] "
                             f"printouts")
    last = res["history"][-1]
    print(f"  {tag}: wall {wall_s:.2f} s; env_loss {env}; {lines.calls} "
          f"[MoE] printouts; last epoch's training step "
          f"{last['step_ms']:.3f} ms, evaluation {last['eval_ms']:.3f} ms "
          f"(CUDA events in the loop); peak device memory "
          f"{peak_gb:.2f} GB, {peak_gb - held_gb:.2f} GB above the "
          f"{held_gb:.2f} GB held before", flush=True)
    return res


def chunked_vs_full(tag, res, ds, dev, want_k2):
    """A ``--eval_chunked 1`` run's model: its layer-wise ``z`` against the
    full eval-mode encode in f32 (on a layout, the fused path with f32
    messages: the layer-wise pass sums f32 messages) to 1e-3, and its
    layer-wise probabilities against the full evaluation's (``want_k2``
    kernel-2 launches in the encode and the evaluation; bf16 messages on a
    layout) where the node keeps its VQ codes on both routes (at least 90%
    of them)."""
    model, graph = res["model"].eval(), res["graph"]
    n = ds.num_nodes
    t0 = time.perf_counter()
    chunked = layerwise_eval_predict(model, res["cfg"], ds, "node",
                                     graph.num_nodes_padded, device=dev)[:n]
    lw_s = time.perf_counter() - t0
    z_lw, _ = layerwise_encode(
        model.encoder, ds.node_features(), ds.edge_index[0],
        ds.edge_index[1], xe=ds.xe, edge_table=ds.edge_text_feat,
        num_nodes=n, device=dev)
    reset_counts()
    with torch.no_grad():
        z_full = task_encode(model, graph)
        full = res["steps"][2](model, graph)[:n].cpu().numpy()
    expect_counts(f"{tag}: the full encode and evaluation", read_counts(),
                  {K2: want_k2})
    z_f32 = z_full
    if graph.layout is not None:
        enc = copy.copy(model.encoder)
        enc.cfg = dataclasses.replace(enc.cfg, fused_bf16_messages=False)
        with torch.no_grad():
            z_f32 = task_encode(TaskModel(enc, model.vq, model.decoder),
                                graph)
    check_close(f"z vs the full f32 encode ({tag}, layer-wise)", z_lw[:n],
                z_f32[:n], 1e-3, 1e-3, what="the layer-wise encode")
    del z_f32
    with torch.no_grad():
        same = (model.vq(z_lw[:n])["indices"]
                == model.vq(z_full[:n])["indices"]).all(1).cpu().numpy()
    check_close(f"{tag}: chunked vs full probabilities (nodes that keep "
                f"their codes)", torch.from_numpy(chunked[same]),
                torch.from_numpy(full[same]), Z_RTOL, Z_ATOL,
                what="the chunked evaluation")
    print(f"  {tag}: layer-wise evaluation {lw_s:.3f} s; {same.mean():.4f} "
          f"of the nodes keep every code; predictions equal on "
          f"{float((chunked.argmax(-1) == full.argmax(-1)).mean()):.4f}",
          flush=True)
    if same.mean() < 0.9:
        raise AssertionError(f"{tag}: only {same.mean():.4f} of the nodes "
                             f"keep their codes")


def bb_pretrain(graph, dev, paths):
    """(b) the full-graph pretrain step with an MoE-SAGE last layer and
    ``lamda_env`` 0.1 on phase pretrain's graph and layout: 3 steps, kernel
    1 once a step (layer 1's dropout tail) and kernel 2 once (the teacher's
    layer 1); finite losses that move, ``env_reg_loss`` below 0; one
    step's gradients against the plain versions; step ms, peak memory."""
    base = pretrain_config(FEAT_DIM)
    cfg = dataclasses.replace(base, lamda_env=0.1, encoder=dataclasses.replace(
        base.encoder, moe=True, moe_layers="last", num_experts=3))
    model = PretrainModel(
        cfg, generator=torch.Generator().manual_seed(SEED)).to(dev)
    teacher = make_teacher(model)
    opt = make_pretrain_optimizer(model, cfg)
    bs = graph.num_nodes_padded
    step = make_pretrain_step(cfg, bs, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    reset_counts()
    losses, spans = [], []
    for _ in range(PRETRAIN_STEPS):
        spans.append([torch.cuda.Event(enable_timing=True)
                      for _ in range(2)])
        spans[-1][0].record()
        out = step(model, teacher, opt, graph)
        spans[-1][1].record()
        losses.append(out)
    paths["bb_moe_pretrain"] = read_counts()
    losses = [{k: float(v) for k, v in ls.items()} for ls in losses]
    # the steps after the first, which pays for the first launches
    step_ms = float(np.mean([a.elapsed_time(b) for a, b in spans[1:]]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect_counts(f"MoE pretrain ({PRETRAIN_STEPS} steps)",
                  paths["bb_moe_pretrain"],
                  {K1: PRETRAIN_STEPS, K2: PRETRAIN_STEPS})
    for i, ls in enumerate(losses):
        print(f"  step {i}: " + ", ".join(f"{k} {v:.6f}"
                                          for k, v in ls.items()),
              flush=True)
    totals = [ls["loss"] for ls in losses]
    if not all(np.isfinite(v) for ls in losses for v in ls.values()) \
            or len(set(totals)) == 1 \
            or not all(ls["env_reg_loss"] < 0 for ls in losses):
        raise AssertionError(f"MoE pretrain losses {losses}")
    draws = draw_step(cfg, graph, torch.Generator(device=dev).manual_seed(7))
    aug = augmented(cfg, graph, draws)

    def grads(plain):
        m, t = copy.deepcopy(model), copy.deepcopy(teacher)
        loss, _, _ = pretrain_forward(
            m, t, cfg, aug, graph, bs=bs, draws=draws,
            drop_seed=draws["drop_seed"], plain=plain,
            generator=torch.Generator(device=dev).manual_seed(7))
        loss.backward()
        return {k: p.grad for k, p in m.named_parameters()}
    reset_counts()
    g_kernel = grads(False)
    expect_counts("one MoE pretrain forward + backward", read_counts(),
                  {K1: 1, K2: 1})
    check_grads("the plain versions (MoE pretrain)", g_kernel, grads(True))
    del g_kernel
    print(f"  MoE pretrain step {step_ms:.3f} ms by CUDA events (mean of "
          f"steps 2-{PRETRAIN_STEPS}); peak device memory {peak_gb:.2f} GB, "
          f"{peak_gb - held_gb:.2f} GB above the {held_gb:.2f} GB held "
          f"before", flush=True)
    del model, teacher, opt, draws, aug
    torch.cuda.empty_cache()


def backbones_run(tmp, graph, dev, paths):
    """Phase backbones (module docstring, phase 17)."""
    ds = load_dataset(DATASET, feat_dim=FEAT_DIM, seed=SEED)
    moe_dir = os.path.join(tmp, "moe")
    os.makedirs(moe_dir, exist_ok=True)
    save_checkpoint(moe_dir, torch.Generator().manual_seed(SEED), moe=True)
    base = ["--finetune_dataset", DATASET, "--feat_dim", str(FEAT_DIM),
            "--seed", str(SEED), "--repeat", "1"]
    moe_ckpt = ["--pretrain_path", moe_dir, "--pretrain_model_epoch", "50"]
    # (a) the MoE finetune: layer 1 (sage) through kernel 2 once a step
    # and once an evaluation
    res = bb_finetune("bb_moe_finetune", [*base, *moe_ckpt, *MOE_FLAGS,
                                          "--epochs", str(EPOCHS)],
                      paths, {K2: 2 * EPOCHS}, EPOCHS)
    model, g, y, mask = (res["model"], res["graph"], res["y"],
                         res["train_mask"])
    loss_fn = res["steps"][0]
    reset_counts()
    g_kernel = step_grads(model, loss_fn, mask, g, y)
    expect_counts("one MoE training step", read_counts(), {K2: 1})
    check_grads("the plain versions (MoE finetune)", g_kernel,
                step_grads(model, loss_fn, mask, g, y, plain=True))
    del g_kernel
    # (d) the layer-wise evaluation (what --eval_chunked 1 runs an epoch)
    # of this model against its full one
    chunked_vs_full("MoE", res, ds, dev, 1 + 1)
    del res, model, g
    # (b) the full-graph pretrain step
    bb_pretrain(graph, dev, paths)
    # (c) the other backbones from scratch (k-means init of the codebook
    # over the full encode): no layout, no kernel; gat evaluates layer-wise
    for bb in ("gcn", "gin", "gat"):
        chunked = ["--eval_chunked", "1"] if bb == "gat" else []
        res = bb_finetune(f"bb_{bb}", [*base, "--backbone", bb,
                                       "--pretrain_dataset", "na",
                                       "--epochs", "1", *chunked],
                          paths, {}, 1)
        if res["graph"].layout is not None or res["graph"].edge_feat \
                is not None:
            raise AssertionError(f"{bb}: the graph carries a layout or "
                                 f"edge features")
        if chunked:
            # (d) the layer-wise evaluation against the full one
            chunked_vs_full("gat", res, ds, dev, 0)
        del res
    # (e) degree_shift_ood with --moe --lamda_env on the fragile graph:
    # kernel 2 once in the k-means init's encode, twice an epoch
    argv = ["--finetune_dataset", OOD_DATASET, "--feat_dim", str(FEAT_DIM),
            "--seed", str(SEED), "--epochs", str(EPOCHS), "--runs", "1",
            "--debug", "--device", "cuda", *MOE_FLAGS]
    print(f"  python -m stemgnn_tpu_torch.scripts.degree_shift_ood "
          f"{' '.join(argv)}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = degree_shift_ood.main(argv)
    paths["bb_moe_ood"] = read_counts()
    wall_s = time.perf_counter() - t0
    expect_counts(f"degree_shift_ood --moe (k-means init, {EPOCHS} x "
                  f"(train step + eval))", paths["bb_moe_ood"],
                  {K2: 1 + 2 * EPOCHS})
    check_ood_payload("degree_shift_ood", res["payload"])
    if res["cfg"].lamda_env != 0.1 or not any(
            k.startswith("encoder.env_encoders.")
            for k in res["best"]["state"]):
        raise AssertionError("degree_shift_ood did not train the MoE layer")
    st = res["best"]["stats"]
    print(f"  degree_shift_ood --moe: wall {wall_s:.2f} s; device ms (CUDA "
          f"events): steps {['%.3f' % v for v in st.get('step_ms', [])]}, "
          f"evals {['%.3f' % v for v in st.get('eval_ms', [])]}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    del res
    torch.cuda.empty_cache()


# ----------------------------------------------------------- phase text

CORA = dict(nodes=2_708, edges=10_556, classes=7)
CORA_LABELS = ("Case_Based", "Genetic_Algorithms", "Neural_Networks",
               "Probabilistic_Methods", "Reinforcement_Learning",
               "Rule_Learning", "Theory")
# texts a run of each encoder (cut by depth from ST 4,096 and 1,024 and e5
# 512 and 256: PERF.md, section 4)
ST_TEXTS, E5_TEXTS, LLAMA_TEXTS, LLAMA_IDS = 512, 128, 16, 128
# the card against the CPU on the same weights: every embedding entry
# within this share of the largest
EMB_RTOL = 1e-4


def synthetic_vocab(rng, path):
    """A 30,522-entry uncased WordPiece ``vocab.txt`` in BERT's order
    ([PAD] 0, [unused*], [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103),
    then punctuation, whole words and ``##`` pieces drawn from the seed.
    Returns the whole words and the punctuation."""
    head = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    punct = [".", ",", ";", ":", "(", ")", "-", "'"]
    n_rest = 30_522 - len(head) - len(punct)
    # random lowercase strings of 2-10 letters, unique, 80% of them whole
    # words and the rest "##" continuation pieces
    codes = rng.integers(97, 123, (2 * n_rest, 10), dtype=np.uint8)
    lens = rng.integers(2, 11, 2 * n_rest)
    cand = list(dict.fromkeys(bytes(c[:k]).decode()
                              for c, k in zip(codes, lens)))[:n_rest]
    n_words = int(0.8 * n_rest)
    words, pieces = cand[:n_words], ["##" + w for w in cand[n_words:]]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(head + punct + words + pieces) + "\n")
    return np.array(words), np.array(punct)


def synthetic_texts(rng, vocab, n, lo=150, hi=250):
    """``n`` texts of ``lo``-``hi`` words from the vocabulary's whole words
    with a punctuation mark every ~12 words and a capital to start."""
    words, punct = vocab
    out = []
    for k in rng.integers(lo, hi + 1, n):
        w = words[rng.integers(0, len(words), int(k))].astype(object)
        marks = rng.random(int(k)) < 1 / 12
        w[marks] = w[marks] + punct[rng.integers(0, len(punct),
                                                 int(marks.sum()))]
        out.append(" ".join(w).capitalize())
    return out


def save_pyg_data(path, payload):
    """``torch.save`` of ``payload`` with each dict in it replaced by a
    PyG 2.3 ``Data`` (its attributes in ``_store._mapping``), pickled under
    the real ``torch_geometric`` module names as PyG writes it; the
    modules are registered for the save only."""
    mods = {n: types.ModuleType(n) for n in (
        "torch_geometric", "torch_geometric.data",
        "torch_geometric.data.data", "torch_geometric.data.storage")}

    class GlobalStorage:
        def __init__(self, mapping, parent=None):
            self._mapping, self._parent = dict(mapping), parent

    class Data:
        def __init__(self, **kw):
            self.__dict__["_store"] = GlobalStorage(kw, parent=self)

    for cls, mod in ((GlobalStorage, "storage"), (Data, "data")):
        cls.__module__ = f"torch_geometric.data.{mod}"
        cls.__qualname__ = cls.__name__
        setattr(mods[cls.__module__], cls.__name__, cls)
    saved = {n: sys.modules.get(n) for n in mods}
    sys.modules.update(mods)
    try:
        obj = (tuple(Data(**p) if isinstance(p, dict) else p
                     for p in payload) if isinstance(payload, tuple)
               else Data(**payload))
        torch.save(obj, path)
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def write_cora_tree(root, vocab, rng):
    """cora's raw files at its size: ``cora.pt`` (a PyG ``Data``: 2,708
    texts of 150-250 words, 7 classes, 10,556 directed edges: 5,000 random
    pairs both ways and 556 duplicates) and ``categories.csv``."""
    os.makedirs(root, exist_ok=True)
    n, n_dup = CORA["nodes"], CORA["edges"] // 19
    pairs = rng.integers(0, n, ((CORA["edges"] - n_dup) // 2, 2))
    ei = np.concatenate([pairs, pairs[:, ::-1]], 0)
    ei = np.concatenate([ei, ei[rng.integers(0, len(ei), n_dup)]]).T
    save_pyg_data(os.path.join(root, "cora.pt"), {
        "raw_texts": synthetic_texts(rng, vocab, n),
        "y": torch.from_numpy(rng.integers(0, CORA["classes"], n)),
        "edge_index": torch.from_numpy(np.ascontiguousarray(ei)),
        "label_names": list(CORA_LABELS)})
    with open(os.path.join(root, "categories.csv"), "w") as f:
        f.write(",description\n" + "".join(
            f'{lab},"{" ".join(synthetic_texts(rng, vocab, 1, 8, 20))}"\n'
            for lab in CORA_LABELS))


def hf_distilbert_state(cfg, gen):
    """A Hugging Face ``DistilBertModel`` state dict at ``cfg``'s widths,
    drawn on ``gen``'s device as HF initializes (weights N(0, 0.02),
    biases 0, norms 1 / 0) and moved to the CPU."""
    dev = gen.device
    d, f = cfg.dim, cfg.hidden_dim

    def w(*shape):
        return torch.empty(shape, device=dev).normal_(0.0, 0.02,
                                                      generator=gen).cpu()

    def lin(name, o, i):
        return {f"{name}.weight": w(o, i), f"{name}.bias": torch.zeros(o)}

    def ln(name):
        return {f"{name}.weight": torch.ones(d), f"{name}.bias":
                torch.zeros(d)}
    sd = {"embeddings.word_embeddings.weight": w(cfg.vocab_size, d),
          "embeddings.position_embeddings.weight":
              w(cfg.max_position_embeddings, d), **ln("embeddings.LayerNorm")}
    for i in range(cfg.n_layers):
        p = f"transformer.layer.{i}"
        for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
            sd.update(lin(f"{p}.attention.{name}", d, d))
        sd.update({**lin(f"{p}.ffn.lin1", f, d), **lin(f"{p}.ffn.lin2", d, f),
                   **ln(f"{p}.sa_layer_norm"),
                   **ln(f"{p}.output_layer_norm")})
    return sd


def write_snapshot(path, vocab_path, cfg, gen):
    """A DistilBERT snapshot directory as Hugging Face lays it out:
    ``vocab.txt`` and ``pytorch_model.bin``.  Returns its size in GB."""
    os.makedirs(path, exist_ok=True)
    shutil.copy(vocab_path, os.path.join(path, "vocab.txt"))
    sd = hf_distilbert_state(cfg, gen)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    return sum(v.numel() * 4 for v in sd.values()) / 1e9


def clone_model(model, device, keep=None):
    """The model's weights on ``device`` (a copy unless they are there
    already) in a new module of its class; with ``keep`` (a config of
    fewer layers) only the embeddings, the layers it names and the final
    norm."""
    cfg = keep or model.cfg
    names = {k for k, _ in type(model)(cfg, device="meta").named_parameters()}
    return load_into(type(model)(cfg, device="meta"),
                     {k: v.to(device) for k, v in model.state_dict().items()
                      if k in names}, device)


@contextlib.contextmanager
def captured_encoders():
    """The text encoders the raw-file loaders build, each with the
    ``history`` of every encode it ran (``enc.histories``)."""
    real, made = raw_parsers.get_text_encoder, []

    def make(*a, **kw):
        enc = real(*a, **kw)
        enc.histories, encode = [], enc.encode

        def encode_kept(texts):
            out = encode(texts)
            enc.histories.append(dict(enc.history))
            return out
        enc.encode = encode_kept
        made.append(enc)
        return enc
    raw_parsers.get_text_encoder = make
    try:
        yield made
    finally:
        raw_parsers.get_text_encoder = real


def encoder_report(tag, enc, peak, card, h=None):
    """One encode's rates, host and device ms a batch, idle share and peak
    memory (``peak``: GB above what was held, and GB held, the model's
    weights among them), from ``h``, by default the encoder's last
    ``history``."""
    peak_gb, held_gb = peak
    h = enc.history if h is None else h
    wall_ms = h["wall_s"] * 1e3
    dev_ms = float(np.sum(h["device_ms"]))
    out = {"texts": h["texts"], "batches": len(h["tokenize_ms"]),
           "batch_size": enc.batch_size, "tokens": h["tokens"],
           "positions": h["positions"], "wall_s": h["wall_s"],
           "texts_per_s": h["texts"] / h["wall_s"],
           "tokens_per_s": h["tokens"] / h["wall_s"],
           "tokenize_ms": float(np.mean(h["tokenize_ms"])),
           "device_ms": float(np.mean(h["device_ms"])),
           "idle": 1.0 - dev_ms / wall_ms, "peak_gb": peak_gb,
           "held_gb": held_gb}
    print(f"  {tag}: {out['texts']} texts in {out['batches']} batches of "
          f"{out['batch_size']}, {out['tokens']} tokens ({out['positions']} "
          f"positions run): {out['texts_per_s']:.1f} texts/s, "
          f"{out['tokens_per_s']:.0f} tokens/s; a batch: host tokenizing "
          f"{out['tokenize_ms']:.3f} ms, device {out['device_ms']:.3f} ms "
          f"(CUDA events); idle share {out['idle']:.4f} of "
          f"{out['wall_s']:.3f} s; peak device memory {peak_gb:.2f} GB "
          f"above the {held_gb:.2f} GB held before it (the weights among "
          f"them); {card}", flush=True)
    return out


def check_embeddings(tag, got, want):
    """Card against CPU: finite, and within ``EMB_RTOL`` of the largest."""
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    ok = np.isfinite(got).all() and err <= EMB_RTOL * scale
    print(f"  {tag}: {got.shape[0]} embeddings of {got.shape[1]}, "
          f"max_abs_err {err:.3e} against the CPU's (largest {scale:.3e}, "
          f"tol {EMB_RTOL} of it) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{tag}: the card's embeddings disagree")
    return err


def measured(enc, texts_or_ids, dev, by_ids=False):
    """The embeddings, and the peak device memory of the encode above what
    was held before it (the model's weights among it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated(dev)
    emb = enc.encode_ids(texts_or_ids) if by_ids else enc.encode(
        texts_or_ids)
    return emb, ((torch.cuda.max_memory_allocated(dev) - held) / 1e9,
                 held / 1e9)


def text_run(dev, paths, card):
    """Phase text (module docstring): cora from raw files through ST into
    the finetune CLI, ST / e5 / Llama-2-7B on the card with their
    card-against-CPU checks, the reference-cache import and the ``.st``
    memmap cache.  The cache root is a temporary directory throughout."""
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tmp_dir = tempfile.TemporaryDirectory()
    root = tmp_dir.name
    saved_root = importers.DEFAULT_CACHE_ROOT
    saved_env = {k: os.environ.pop(k, None) for k in (
        "ST_MODEL_DIR", "E5_MODEL_DIR", "LLAMA2_7B_MODEL_DIR")}
    importers.DEFAULT_CACHE_ROOT = root
    reports = {}
    try:
        # (a) cora from its raw files through ST, into the finetune CLI
        t0 = time.perf_counter()
        vocab_path = os.path.join(root, "vocab.txt")
        vocab = synthetic_vocab(rng, vocab_path)
        write_cora_tree(os.path.join(root, "raw", "single_graph", "Cora"),
                        vocab, rng)
        st_dir = text_encoder.default_model_dir("ST")
        gb = write_snapshot(st_dir, vocab_path, DistilBertConfig(), gen)
        print(f"  (a) cora's raw tree ({CORA['nodes']} texts of 150-250 "
              f"words, {CORA['edges']} directed edges, {CORA['classes']} "
              f"classes, a PyG cora.pt) and a DistilBERT snapshot at "
              f"multi-qa-distilbert-cos-v1's widths ({gb:.3f} GB) written "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
        st_dim = DistilBertConfig().dim
        argv = ["--finetune_dataset", "cora", "--use_params",
                "--text_encoder", "ST", "--feat_dim", str(st_dim),
                "--hidden_dim", str(st_dim), "--code_dim", str(st_dim),
                "--epochs", str(EPOCHS), "--repeat", "1", "--seed",
                str(SEED), "--debug"]
        print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)}",
              flush=True)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated(dev)
        with captured_encoders() as made:
            reset_counts()
            res = finetune_main(argv)
            paths["text_cora"] = read_counts()
        peak = ((torch.cuda.max_memory_allocated(dev) - held) / 1e9,
                held / 1e9)
        print(f"  finetune wall {time.perf_counter() - t0:.2f} s with the "
              f"raw parse and the encoding; "
              f"{describe_layout(res['graph'].layout)}", flush=True)
        expect_counts(f"cora (k-means init, {EPOCHS} x (train step + eval))",
                      paths["text_cora"], {K2: 2 + EPOCHS * (3 + 2)})
        check_losses(res)
        if len(made) != 1 or not isinstance(made[0], SentenceEncoder):
            raise AssertionError(f"the loader built {made}, not one ST "
                                 f"encoder")
        if made[0].device.type != dev.type:
            raise AssertionError("cora's texts were encoded off the card")
        reports["ST cora"] = encoder_report(
            "ST on cora's node texts (in the finetune's load; the peak the "
            "whole finetune's)", made[0], peak, card, made[0].histories[0])
        ds = importers.load_dataset_cache("cora", "ST", st_dim)
        if ds is None or ds.node_text_feat.shape != (CORA["nodes"], st_dim):
            raise AssertionError(f"no ST cache of cora at {st_dim} dims")
        del res, made
        st = SentenceEncoder.from_dir(st_dir, device=dev)
        short = synthetic_texts(rng, vocab, 32, 20, 45)
        reports["ST cora"]["max_abs_err"] = check_embeddings(
            "ST card vs CPU", st.encode(short),
            SentenceEncoder(clone_model(st.model, "cpu"),
                            st.tokenizer).encode(short))

        # (b) ST throughput
        t0 = time.perf_counter()
        texts = synthetic_texts(rng, vocab, ST_TEXTS)
        print(f"  (b) {ST_TEXTS} texts generated in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        emb, peak = measured(st, texts, dev)
        if emb.shape != (ST_TEXTS, st_dim) or not np.isfinite(emb).all() or \
                not np.allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5):
            raise AssertionError("ST embeddings not finite unit rows")
        reports["ST"] = encoder_report("ST", st, peak, card)
        del st, emb
        torch.cuda.empty_cache()

        # (c) e5 at e5-large-v2's widths, built on the card from the seed
        # (the snapshot route is ST's above)
        t0 = time.perf_counter()
        e5 = E5Encoder(BertModel(BertConfig(), generator=gen, device=dev),
                       WordPieceTokenizer.from_vocab_file(vocab_path))
        torch.cuda.synchronize()
        print(f"  (c) e5 built on the card in {time.perf_counter() - t0:.2f}"
              f" s: {e5.model.cfg}", flush=True)
        emb, peak = measured(e5, synthetic_texts(rng, vocab, E5_TEXTS), dev)
        if emb.shape != (E5_TEXTS, e5.dim) or not np.isfinite(emb).all():
            raise AssertionError("e5 embeddings not finite")
        reports["e5"] = encoder_report("e5", e5, peak, card)
        short = synthetic_texts(rng, vocab, 4, 20, 45)
        reports["e5"]["max_abs_err"] = check_embeddings(
            "e5 card vs CPU", e5.encode(short),
            E5Encoder(clone_model(e5.model, "cpu"), e5.tokenizer).encode(
                short))
        del e5, emb
        torch.cuda.empty_cache()

        # (d) Llama-2-7B's widths, 32 layers, on the card from the seed
        t0 = time.perf_counter()
        llama = LlamaModel(LlamaConfig(), generator=gen, device=dev)
        torch.cuda.synchronize()
        print(f"  (d) Llama-2-7B's widths built on the card in "
              f"{time.perf_counter() - t0:.2f} s: "
              f"{sum(p.numel() for p in llama.parameters()) / 1e9:.3f}B "
              f"parameters, {llama.cfg}", flush=True)
        lengths = rng.integers(LLAMA_IDS - 24, LLAMA_IDS + 1, LLAMA_TEXTS)
        ids = np.full((LLAMA_TEXTS, LLAMA_IDS), 2, np.int32)   # EOS = 2
        for i, k in enumerate(lengths):
            ids[i, 0] = 1                                      # BOS
            ids[i, 1:k] = rng.integers(3, llama.cfg.vocab_size, k - 1)
        enc = LlamaEncoder(llama, pad_id=2)
        emb, peak = measured(enc, ids, dev, by_ids=True)
        if emb.shape != (LLAMA_TEXTS, llama.cfg.dim) or \
                not np.isfinite(emb).all():
            raise AssertionError("llama embeddings not finite")
        enc.history["tokens"] = int(lengths.sum())
        reports["llama2_7b"] = encoder_report("llama2_7b", enc, peak, card)
        two = LlamaConfig(n_layers=2)
        reports["llama2_7b"]["max_abs_err"] = check_embeddings(
            "llama2_7b (its first 2 layers) card vs CPU",
            LlamaEncoder(clone_model(llama, dev, two),
                         pad_id=2).encode_ids(ids[:2]),
            LlamaEncoder(clone_model(llama, "cpu", two),
                         pad_id=2).encode_ids(ids[:2]))
        del llama, enc, emb
        torch.cuda.empty_cache()

        # (e) the importers at cora's size
        t0 = time.perf_counter()
        ref = os.path.join(root, "geometric_data_processed.pt")
        save_pyg_data(ref, ({
            "x": torch.from_numpy(ds.x), "xe": torch.from_numpy(ds.xe),
            "edge_index": torch.from_numpy(ds.edge_index),
            "y": torch.from_numpy(ds.labels),
            "node_text_feat": torch.from_numpy(ds.node_text_feat),
            "edge_text_feat": torch.from_numpy(ds.edge_text_feat),
            "class_node_text_feat": torch.from_numpy(
                ds.class_node_text_feat)}, None))
        imported = importers.import_reference_cache(ref, "cora")
        st_path = importers.save_dataset_cache_memmap(ds, "ST", root=root)
        back = importers.load_dataset_cache_memmap("cora", "ST", st_dim,
                                                   root=root)
        for k in ("node_text_feat", "edge_text_feat", "class_node_text_feat",
                  "x", "xe", "edge_index", "labels"):
            for tag, got in (("reference cache", imported), (".st", back)):
                if not np.array_equal(np.asarray(getattr(got, k)),
                                      getattr(ds, k)):
                    raise AssertionError(f"{tag}: {k} differs")
        if not isinstance(back.node_text_feat, np.memmap) or \
                "torch_geometric" in sys.modules:
            raise AssertionError("the .st cache is not memory-mapped, or "
                                 "the PyG stubs outlived the import")
        print(f"  (e) a reference PyG cache of cora imported and an .st "
              f"cache ({st_path}) written and memory-mapped back, equal, in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    finally:
        importers.DEFAULT_CACHE_ROOT = saved_root
        for k, v in saved_env.items():
            if v is not None:
                os.environ[k] = v
        tmp_dir.cleanup()
    print(json.dumps({"text_encoders": reports}), flush=True)
    return reports


# ------------------------------------------------------------ phase locality

class Relabels:
    """Records each relabel an entry point makes (``graph_setup.
    reorder_dataset``, which ``maybe_reorder_dataset`` calls): (method,
    dataset before, dataset after, host seconds)."""

    def __enter__(self):
        self.done, self.real = [], graph_setup.reorder_dataset

        def timed(ds, method="rcm", task="node"):
            t0 = time.perf_counter()
            out = self.real(ds, method, task)
            self.done.append((method, ds, out, time.perf_counter() - t0))
            return out
        graph_setup.reorder_dataset = timed
        return self

    def __exit__(self, *exc):
        graph_setup.reorder_dataset = self.real
        return False


def locality_finetunes(tmp, dev, paths):
    """``finetune.main --reorder off|rcm|community|degree`` on
    ``arxiv_synthetic``, 1 epoch each, dropout 0, from phase slice's
    checkpoint: each relabelled run's epoch loss within LOC_LOSS_RTOL of
    the unrelabelled run's, and its ``z`` mapped back through
    ``node_perm`` against the unrelabelled graph's (same model, the ``z``
    gates)."""
    base = ["--finetune_dataset", LOCALITY, "--feat_dim", str(FEAT_DIM),
            "--pretrain_path", tmp, "--pretrain_model_epoch", "50",
            "--seed", str(SEED), "--epochs", "1", "--repeat", "1",
            "--dropout", "0"]
    graph_off, loss_off = None, None
    for mode in ("off", *REORDERS):
        argv = [*base, "--reorder", mode]
        reset_counts()
        t0 = time.perf_counter()
        with Relabels() as rl:
            res = finetune_main(argv)
        paths[f"locality_{mode}"] = read_counts()
        wall = time.perf_counter() - t0
        expect_counts(f"finetune --reorder {mode} (train step + eval)",
                      paths[f"locality_{mode}"], {K2: 3 + 2})
        check_losses(res, epochs=1)
        loss = res["epoch_losses"][0]["loss"]
        if mode == "off":
            if rl.done:
                raise AssertionError("--reorder off relabelled the graph")
            graph_off, loss_off = res["graph"], loss
            print(f"  --reorder off: loss {loss:.6f}, wall {wall:.2f} s",
                  flush=True)
            continue
        (method, _, after, host_s), = rl.done
        perm = torch.from_numpy(after.extras["node_perm"]).to(dev)
        rel = abs(loss - loss_off) / abs(loss_off)
        print(f"  --reorder {mode}: relabel {host_s:.2f} s of host, loss "
              f"{loss:.6f} ({rel:.2e} relative to off's), wall {wall:.2f} s",
              flush=True)
        if method != mode or rel > LOC_LOSS_RTOL:
            raise AssertionError(f"--reorder {mode}: loss {loss} vs {loss_off}")
        model = res["model"].eval()
        with torch.no_grad():
            n = after.num_nodes
            z = task_encode(model, res["graph"])[:n]
            z_off = task_encode(model, graph_off)[:n]
            check_z(f"--reorder {mode} z mapped back through node_perm "
                    f"(unrelabelled graph, same model)", z,
                    z_off.index_select(0, perm), n)
        del res, model, z, z_off
    del graph_off
    torch.cuda.empty_cache()


def locality_kg(dev, paths):
    """WN18RR's full-batch preset with ``--reorder community``, 1 epoch:
    the relabel keeps each link label and split in its slot."""
    argv = ["--finetune_dataset", "WN18RR", "--use_params", "--epochs", "1",
            "--repeat", "1", "--seed", str(SEED), "--debug", "--reorder",
            "community"]
    print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)}",
          flush=True)
    reset_counts()
    with Relabels() as rl:
        res = finetune_main(argv)
    paths["locality_wn18rr"] = read_counts()
    expect_counts("WN18RR --reorder community (k-means init, train step + "
                  "eval)", paths["locality_wn18rr"], {K2: 2 + 3 + 2})
    check_losses(res, epochs=1)
    (_, before, after, host_s), = rl.done
    kept = (np.array_equal(after.labels, before.labels) and all(
        np.array_equal(a[k], b[k]) for a, b in zip(after.splits,
                                                   before.splits)
        for k in b))
    moved = int((after.edge_index != before.edge_index).any(0).sum())
    print(f"  WN18RR community relabel {host_s:.2f} s of host; "
          f"{moved} of {before.num_edges} edges renamed; link labels and "
          f"splits in their slots: {kept}", flush=True)
    if not kept or not moved:
        raise AssertionError("the WN18RR relabel moved link labels or "
                             "renamed nothing")
    del res


def locality_prepare(dev):
    """What phase locality reads and no earlier phase made: the relabelled
    finetunes' dataset (loaded through the shared registry) and the split
    layouts (:func:`locality_split_layouts`)."""
    load_dataset(LOCALITY, feat_dim=FEAT_DIM, seed=SEED)
    return locality_split_layouts(dev)


def locality_split_layouts(dev):
    """The shuffled community graph (LOC_NODES nodes, LOC_EDGES edges,
    LOC_COMMUNITIES communities), community-ordered, and its layouts with
    ``loc_split="on"`` (and the merged metadata), without and with hub
    blocks: ({name: (unsplit view, split layout)}, N_pad, the lines to
    print).  Host work and copies, no kernel: the smoke builds them in a
    thread beside phase backbones, whose device work leaves the host
    idle."""
    notes = []
    t0 = time.perf_counter()
    _, s, r, _ = community_power_law_graph(
        LOC_NODES, LOC_EDGES, 8, num_communities=LOC_COMMUNITIES, seed=SEED)
    t1 = time.perf_counter()
    s, r, _ = relabel(community_order(s, r, LOC_NODES), s, r)
    notes.append(f"community graph {LOC_NODES} nodes / {LOC_EDGES} edges "
                 f"in {LOC_COMMUNITIES} communities, ids shuffled: generated "
                 f"in {t1 - t0:.2f} s, community_order "
                 f"{time.perf_counter() - t1:.2f} s of host")
    s, r = s.astype(np.int32), r.astype(np.int32)
    n_pad = -(-LOC_NODES // 128) * 128
    hub = dict(hub_size=FinetuneConfig().hub_size,
               sc_hub_size=FinetuneConfig().sc_hub_size,
               hub_min_coverage=-1.0)
    lays = {}
    for name, kw in (("nohub", {}), ("hub", hub)):
        t0 = time.perf_counter()
        split = build_edge_layout(s, r, n_pad, device=dev, loc_split="on",
                                  loc_merge=True, **kw)
        sp = split.split_r if name == "nohub" else split.hub_r.tail.split_r
        notes.append(f"{name}: split layout {time.perf_counter() - t0:.2f} "
                     f"s of host; local fraction {sp.loc_frac:.4f} (receiver "
                     f"order); {describe_layout(split)}")
        lays[name] = (unsplit_view(split), split)
    return lays, n_pad, notes


def unsplit_view(lay):
    """The same layout without its local/stray splits (the splits are extra
    fields beside the unsplit arrays): the unsplit route on one graph."""
    def bare(sub):
        return dataclasses.replace(sub, split_r=None, split_s=None)
    out = bare(lay)
    for order in ("r", "s"):
        hub = getattr(lay, "hub_" + order)
        if hub is not None:
            out = dataclasses.replace(out, **{"hub_" + order: dataclasses
                                              .replace(hub,
                                                       tail=bare(hub.tail))})
    return out


def locality_split_run(dev, paths, prep):
    """The community graph's layouts with ``loc_split="on"`` (and the merged
    metadata), without and with hub blocks (``prep``, from
    :func:`locality_split_layouts`), against the same graph's unsplit
    layouts: ``fused_sage_aggregate`` forward and backward through
    the two-launch split and the merged launch, against the plain versions
    (the kernel tolerance of the out dtype) and against the unsplit layout
    (the ``z`` gates), launches counted.  Returns kernel 2's stray case
    (check and times) and the split's kernel 1 and kernel 2 launches,
    checked and timed."""
    lays, n_pad, notes = prep
    print("".join(f"  {line} (built beside phase backbones)\n"
                  for line in notes), end="", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x32 = torch.randn(n_pad, FEAT_DIM, device=dev, generator=gen)
    # one upstream gradient for every route: the backward rounds its input
    # to bf16, so upstream gradients that differ by f32 noise (each
    # route's own forward) could differ there by a bf16 ulp
    g32 = torch.randn(n_pad, FEAT_DIM, device=dev, generator=gen)
    calls = {}
    real = {K1: fused_sage.scatter_rows_sorted,
            K2: fused_sage.gathered_scatter_rows_sorted}

    def run(lay, x, merged, plain=False, record=None):
        xi = x.detach().clone().requires_grad_()
        if record is not None:
            for k in real:
                def rec(*a, _k=k, **kw):
                    calls.setdefault((record, _k), []).append((a, kw))
                    return real[_k](*a, **kw)
                setattr(fused_sage, k, rec)
        try:
            out = fused_sage.fused_sage_aggregate(xi, lay, None,
                                                  loc_merged=merged,
                                                  plain=plain)
            out.backward(g32.to(out.dtype))
        finally:
            for k, f in real.items():
                setattr(fused_sage, k, f)
        torch.cuda.synchronize()
        return out.detach(), xi.grad
    for name, (unsplit, split) in lays.items():
        for merged in (False, True):
            # the hub case in f32 only: its bf16 passes take the routes
            # nohub checks in bf16.  Hub tails carry no merged metadata:
            # merged there is the two-launch route again, run for its
            # launch counts
            for dt in ((torch.float32,) if name == "hub"
                       else (torch.float32, torch.bfloat16)):
                tag = (f"{name} {'merged' if merged else 'two-launch'} "
                       f"{str(dt)[6:]}")
                x = x32.to(dt)
                reset_counts()
                key = f"{name}_{'merged' if merged else 'two'}"
                out, grad = run(split, x, merged,
                                record=key if dt == torch.float32 else None)
                got = read_counts()
                paths.setdefault(f"locality_{key}", got)
                # the merged launch exists where the split carries the
                # merged metadata (not on hub tails, as in JAX)
                one = merged and name == "nohub"
                expect_counts(f"{tag} forward + backward", got,
                              {K2: 2} if one else {K1: 2, K2: 2})
                p_out, p_grad = run(split, x, merged, plain=True)
                check_kernel(f"{tag} out vs the plain versions", out, p_out,
                             out.dtype)
                check_kernel(f"{tag} dx vs the plain versions", grad,
                             p_grad, grad.dtype)
                u_out, u_grad = run(unsplit, x, False)
                check_z(f"{tag} out on the unsplit layout", out, u_out,
                        LOC_NODES)
                check_z(f"{tag} dx on the unsplit layout", grad, u_grad,
                        LOC_NODES)
    del x32, g32
    # kernel 2's merged launch with stray inputs, and the two-launch
    # chain's kernel 1 (strays) and kernel 2 (local) launches: each checked
    # against its plain version and timed
    merged_call = calls[("nohub_merged", K2)][0]
    stray = launch_case("kernel 2 merged split (stray inputs, forward)", K2,
                        "locsplit_merged", merged_call)
    k1 = launch_case("kernel 1 locsplit stray pass (forward)", K1,
                     "locsplit_stray", calls[("nohub_two", K1)][0])
    k2 = launch_case("kernel 2 locsplit local pass (forward, init)", K2,
                     "locsplit_local", calls[("nohub_two", K2)][0])
    # the routes over the same receiver-order edges: the unsplit kernel 2,
    # the two-launch chain (gather + kernel 1 + kernel 2) and the merged
    # route (the stray buffer's gather + kernel 2)
    unsplit, split = lays["nohub"]
    a, kw = merged_call
    x = a[3]
    common = dict(num_nodes_padded=kw["num_nodes_padded"],
                  relu=kw.get("relu"), scale=kw.get("scale"))
    route = dict(t0=None, out_dtype=torch.float32, plain=False, **common)
    routes = dict(
        unsplit_ms=cuda_ms(lambda: sc.gathered_scatter_rows_sorted(
            unsplit.senders_r[None, :], unsplit.lrow_r, unsplit.block_ptr_r,
            x, plan=unsplit.plan_r, **common), 20),
        chain_ms=cuda_ms(lambda: fused_sage._split(x, split.split_r, "r",
                                                   **route), 20),
        merged_route_ms=cuda_ms(lambda: fused_sage._split(
            x, split.split_r, "r", merged=True, **route), 20))
    print("  receiver-order routes on the community graph: " + ", ".join(
        f"{k[:-3].replace('_', ' ')} {v:.3f} ms" for k, v in routes.items()),
        flush=True)
    stray[1].update(routes)
    del lays, calls
    torch.cuda.empty_cache()
    return stray, k1, k2


def locality_run(tmp, dev, paths, prep):
    locality_finetunes(tmp, dev, paths)
    locality_kg(dev, paths)
    return locality_split_run(dev, paths, prep)


# ------------------------------------------------------------ phase halo

# each epoch's loss of the halo finetune against the single-device one:
# the same bf16 messages summed in another order, and BatchNorm's moments
# from the ranks' sums
HALO_LOSS_RTOL = 1e-3
HALO_SHARDS = 2
# phase halo_pretrain: the epochs (one step each) and hub blocks of the
# halo pretrain, the 2 x 2 grid's graph (an eighth of arxiv's nodes) and
# epochs, the data-parallel ranks and steps; step 1's losses at S = 2 held
# against S = 1's (the topo losses differ by design: positives and
# negatives sampled per shard)
HP_EPOCHS, HP_HUB = 3, 2048
HP_GRID, HP_GRID_NODES, HP_GRID_EPOCHS = (2, 2), 169_343 // 8, 2
DP_RANKS, DP_STEPS = 2, 4
HP_SAME = ("feat_recon_loss", "sem_recon_loss", "commit_loss")


def halo_rem_layout(ds, shard, dev):
    """Rank ``shard``'s remote layout of the 2-rank partition of ``ds``,
    built here as the ranks build theirs (every shard's layouts, for the
    decisions across shards; no kernel launches), and layer 1's halo
    buffer on it: the exchanged feature rows, padded to the layout's node
    space.  Returns a list of one (layout, buffer, edge table, host
    seconds), which its reader empties: the future that returns it then
    holds no device memory."""
    t0 = time.perf_counter()
    ei = np.asarray(ds.edge_index)
    part, nb, R = halo.build_halo_partition(ei[0], ei[1], ds.num_nodes,
                                            HALO_SHARDS, xe_ids=ds.xe)
    lay_rem = halo.build_halo_layouts(
        part, nb, R, HALO_SHARDS, hub_size=FinetuneConfig().hub_size,
        feat_dim_hint=FEAT_DIM, device=dev)[shard][1]
    send = part["send_idx"][:, shard]                   # [S(owner), R]
    rows = (np.arange(HALO_SHARDS)[:, None] * nb + send).reshape(-1)
    x = np.zeros((lay_rem.num_nodes_padded, FEAT_DIM), np.float32)
    ok = rows < ds.num_nodes
    x[:len(rows)][ok] = ds.node_text_feat[np.asarray(ds.x)[rows[ok]]]
    table = torch.as_tensor(ds.edge_text_feat, dtype=torch.float32,
                            device=dev)
    return [(lay_rem, torch.from_numpy(x).to(dev), table,
             time.perf_counter() - t0)]


def halo_rem_call(lay_rem, x, table):
    """The kernel-2 launch of ``fused_sage_aggregate`` over the remote
    layout (layer 1's forward), recorded: (arguments, keywords)."""
    calls = []
    real = fused_sage.gathered_scatter_rows_sorted

    def record(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    fused_sage.gathered_scatter_rows_sorted = record
    try:
        fused_sage.fused_sage_aggregate(x, lay_rem, table, reduce="sum")
    finally:
        fused_sage.gathered_scatter_rows_sorted = real
    if len(calls) != 1:
        raise AssertionError(f"the remote layout's forward launched kernel "
                             f"2 {len(calls)} times")
    return calls[0]


def halo_check(tag, res, want_losses, z_want, n, shards):
    """One halo run's gates: the ranks, each epoch's loss against the
    single-device run's, each rank's block of ``z`` against the single-
    device ``z``, kernel 2 on both layouts of each rank (none of kernel 1 or
    3 at S > 1); prints each rank's measurements."""
    ranks = res["ranks"]
    if [r["rank"] for r in ranks] != list(range(shards)):
        raise AssertionError(f"{tag}: ranks {[r['rank'] for r in ranks]}")
    for rec in ranks:
        hist = rec["history"]
        losses = [h["losses"]["loss"] for h in hist]
        if len(losses) != len(want_losses) or not all(
                abs(a - b) <= HALO_LOSS_RTOL * abs(b)
                for a, b in zip(losses, want_losses)):
            raise AssertionError(f"{tag} rank {rec['rank']}: losses "
                                 f"{losses} vs single-device {want_losses}")
        nb = rec["nb"]
        lo, hi = rec["rank"] * nb, min((rec["rank"] + 1) * nb, n)
        check_z(f"{tag} rank {rec['rank']}'s block (rows {lo}..{hi})",
                torch.from_numpy(rec["z"][:hi - lo]), z_want[lo:hi],
                hi - lo)
        ex = [h.get("exchange_ms", 0.0) for h in hist]
        print(f"  {tag} rank {rec['rank']}: backend {rec['backend']} on "
              f"{rec['device']}; nb {nb}, R {rec['R']}, remote node space "
              f"{rec['m_rem']}, edges local {rec['edges_loc']} / remote "
              f"{rec['edges_rem']}; partition {rec['partition_s']:.2f} s, "
              f"layouts {rec['layout_s']:.2f} s of host; exchanged "
              f"{[b / 1e6 for b in rec['exchange_bytes']]} MB a layer each "
              f"way; per epoch: wall "
              f"{['%.1f' % h['epoch_ms'] for h in hist]} ms, step "
              f"{['%.1f' % h.get('step_ms', 0) for h in hist]} ms, "
              f"evaluation {['%.1f' % h.get('eval_ms', 0) for h in hist]} "
              f"ms, exchanges {['%.2f' % v for v in ex]} ms (CUDA events), "
              f"idle share {[h['idle'] for h in hist]}; launches "
              f"{rec['launches']}, on the local layout "
              f"{rec['launches_loc']}, on the remote {rec['launches_rem']}",
              flush=True)
        want = {"loc": {K1: 0, K2: EPOCHS * (3 + 2), K3: 0},
                "rem": {K1: 0, K2: EPOCHS * (3 + 2) if shards > 1 else 0,
                        K3: 0}}
        for side in ("loc", "rem"):
            expect_counts(f"{tag} rank {rec['rank']} {side} layout",
                          {k: rec[f"launches_{side}"].get(k, 0)
                           for k in (K1, K2, K3)}, want[side])
        if shards == 1 and rec["edges_rem"]:
            raise AssertionError(f"{tag}: {rec['edges_rem']} remote edges")


def halo_run(dev, paths, ref, rem):
    """Phase halo (module docstring): the 2-rank shared-card run (its ranks
    started at phase backbones) and beside it the 1-rank NCCL run of
    ``finetune.main --halo_shards`` with phase train's flags, held against
    its run (``ref``: its argv, losses and final ``z``), and rank 1's
    remote layout case (``rem``: the future of :func:`halo_rem_layout`,
    built beside phase backbones).  Returns kernel 2's (max_abs_err,
    times) on that case."""
    argv, want, z_want = ref
    n = z_want.shape[0]

    def run(shards):
        flags = [*argv, "--halo_shards", str(shards), "--debug"]
        print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(flags)}",
              flush=True)
        t0, clock0 = time.perf_counter(), time.time()
        res = finetune_cli.main(flags, keep_z=True)
        return res, time.perf_counter() - t0, clock0

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the 1-rank run beside the 2-rank run: its layout build beside
        # theirs, its 2 epochs beside their first
        one = pool.submit(run, 1)
        runs = {HALO_SHARDS: run(HALO_SHARDS), 1: one.result()}
    for shards, (res, wall, clock0) in runs.items():
        tag = f"halo S={shards}"
        spans = [" / ".join("%.2f" % (t - clock0) for t in
                            [*r.get("start_marks", {}).values(), *r["span"]])
                 for r in res["ranks"]]
        print(f"  {tag}: wall {wall:.2f} s; each rank "
              f"{'(started at phase backbones) imported its modules, '
                 'joined the group, imported the compiler stack, read the '
                 'call, ' if shards > 1 else ''}"
              f"entered its run, began its first epoch and ended training "
              f"at {spans} s from the call (negative: before it; after "
              f"training: the final z and the results' return)",
              flush=True)
        halo_check(tag, res, want, z_want, n, shards)
        for rec in res["ranks"]:
            paths[f"halo{shards}_rank{rec['rank']}"] = {
                k: rec["launches"].get(k, 0) for k in (K1, K2, K3)}
    del runs
    lay_rem, x, table, host_s = rem.result().pop()
    print(f"  rank 1's remote layout, built here beside phase backbones in "
          f"{host_s:.2f} s of host: {describe_layout(lay_rem)}", flush=True)
    return launch_case("kernel 2 on rank 1's remote layout (layer 1 "
                       "forward)", K2, "halo_rem",
                       halo_rem_call(lay_rem, x, table))


# ------------------------------------------------- phase halo_pretrain

def held_line(top: int = 6):
    """Print the device memory this process holds (after a collection and
    with the allocator's cache emptied) and its largest CUDA tensors."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    sizes = {}
    for obj in gc.get_objects():
        try:
            if torch.is_tensor(obj) and obj.is_cuda:
                sizes[obj.data_ptr()] = (obj.untyped_storage().nbytes(),
                                         tuple(obj.shape), obj.dtype)
        except Exception:    # noqa: BLE001 - objects that refuse to answer
            continue
    big = sorted(sizes.values(), key=lambda v: -v[0])[:top]
    print(f"  held by this process before the phase: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; largest "
          f"tensors " + ", ".join(f"{b / 1e9:.2f} GB {list(sh)} "
                                 f"{str(dt)[6:]}" for b, sh, dt in big),
          flush=True)


def hp_rem_layout(ds, shard, dev):
    """Rank ``shard``'s remote layout of the halo pretrain's 2-rank
    partition of ``ds`` (hub and scatter-side blocks of ``HP_HUB``; every
    shard's layouts, for the decisions across shards), layer 1's halo
    buffer on it, the edge table and a dropout view over the global ids of
    its rows.  Returns a list of one (layout, buffer, table, view, host
    seconds), which its reader empties."""
    t0 = time.perf_counter()
    node_feat = ds.node_text_feat[np.asarray(ds.x)]
    sg, nb, R, part = halo_pretrain_arrays(node_feat, ds.edge_index,
                                           HALO_SHARDS, ds.xe)
    lay_rem = halo.build_halo_layouts(
        part, nb, R, HALO_SHARDS, hub_size=HP_HUB, sc_hub_size=HP_HUB,
        feat_dim_hint=FEAT_DIM, device=dev)[shard][1]
    rows = (np.arange(HALO_SHARDS)[:, None] * nb
            + part["send_idx"][:, shard]).reshape(-1)
    x = np.zeros((lay_rem.num_nodes_padded, FEAT_DIM), np.float32)
    x[:len(rows)] = sg["node_feat"].reshape(-1, FEAT_DIM)[rows]
    table = torch.as_tensor(ds.edge_text_feat, dtype=torch.float32,
                            device=dev)
    seed = dropout_edge_seed(torch.Generator(device=dev).manual_seed(SEED),
                             dev)
    view = DropView(lay_rem, seed, pretrain_config(FEAT_DIM).edge_p,
                    ids=(torch.from_numpy(sg["gid_rem_src"][shard]).to(dev),
                         shard * nb))
    return [(lay_rem, torch.from_numpy(x).to(dev), table, view,
             time.perf_counter() - t0)]


def hp_rem_call(lay_rem, x, table, view):
    """The kernel-1 launch of ``fused_sage_aggregate`` under the dropout
    view over the remote layout (layer 1's forward: its hub tail, or the
    whole layout without a hub block), recorded: (arguments, keywords)."""
    calls = []
    real = fused_sage.scatter_rows_sorted

    def record(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    fused_sage.scatter_rows_sorted = record
    try:
        fused_sage.fused_sage_aggregate(x, lay_rem, table, reduce="sum",
                                        drop_hash=view)
    finally:
        fused_sage.scatter_rows_sorted = real
    if len(calls) != 1:
        raise AssertionError(f"the dropped remote layout's forward launched "
                             f"kernel 1 {len(calls)} times")
    return calls[0]


def hp_check(tag, recs, shards, num_data, epochs):
    """One halo pretrain run's gates: the grid of ranks, finite losses, the
    parameters' digests equal across ranks after every step, every
    layout's keeps on the card equal to the CPU's, and each epoch's kernel
    launches on each rank's layouts (kernel 1 three times a layout: the
    student's two dropped forwards and layer 2's backward; the teacher's
    two clean forwards through kernel 2 where the forward tail gathers in
    the kernel, else kernel 1; the remote layout only at S > 1); prints
    each rank's measurements.  Returns each rank's launches over the run."""
    grid = [(r["data"], r["edge"]) for r in recs]
    if grid != [(d, e) for d in range(num_data) for e in range(shards)]:
        raise AssertionError(f"{tag}: ranks at {grid}")
    digests = [r["digests"] for r in recs]
    if len(digests[0]) != epochs or any(d != digests[0] for d in digests):
        raise AssertionError(f"{tag}: parameters differ across ranks "
                             f"({digests})")
    totals = []
    for rec in recs:
        who = (f"{tag} rank {rec['rank']} (data {rec['data']}, edge "
               f"{rec['edge']})")
        hist = rec["history"]
        for h in hist:
            if not all(np.isfinite(v) for v in h["losses"].values()):
                raise AssertionError(f"{who}: losses {h['losses']}")
        for side, rep in rec["keeps"].items():
            if rep["differ"] or rep["hub_differ"] or not rep["edges"]:
                raise AssertionError(f"{who} {side} keeps: {rep}")
        total = {K1: 0, K2: 0, K3: 0}
        for side in ("loc", "rem"):
            g = rec["gwin"][side]["r"]["gwin"]
            want = ({K1: 3 + (0 if g else 2), K2: 2 if g else 0, K3: 0}
                    if side == "loc" or shards > 1
                    else {K1: 0, K2: 0, K3: 0})
            for e, h in enumerate(hist):
                got = {k: h["launches"][side].get(k, 0) for k in want}
                if got != want:
                    raise AssertionError(f"{who} {side} layout epoch {e}: "
                                         f"launches {got}, expected {want}")
                for k in total:
                    total[k] += got[k]
        totals.append(total)
        print(f"  {who}: backend {rec['backend']} on {rec['device']}; nb "
              f"{rec['nb']}, R {rec['R']}, remote node space {rec['m_rem']},"
              f" edges local {rec['edges_loc']} / remote {rec['edges_rem']};"
              f" partition {rec['partition_s']:.2f} s, layouts "
              f"{rec['layout_s']:.2f} s of host; forward tails "
              f"{rec['gwin']}; keeps {rec['keeps']}; per epoch: wall "
              f"{['%.1f' % h['epoch_ms'] for h in hist]} ms, step "
              f"{['%.1f' % h.get('step_ms', 0) for h in hist]} ms, "
              f"exchanges {['%.1f' % h.get('exchange_ms', 0) for h in hist]}"
              f" ms (CUDA events), idle share "
              f"{['%.4f' % h['idle'] for h in hist]}, peak "
              f"{['%.2f' % h['peak_gb'] for h in hist]} GB; launches a step "
              f"{hist[0]['launches']}", flush=True)
    for e, h in enumerate(recs[0]["history"]):
        print(f"  {tag} epoch {e + 1}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in sorted(h["losses"].items())),
            flush=True)
    return totals


def hp_base():
    """The pretrain CLI's flags of phase halo_pretrain's runs."""
    return ["--pretrain_dataset", DATASET, "--feat_dim", str(FEAT_DIM),
            "--seed", str(SEED), "--epochs", str(HP_EPOCHS), "--save_every",
            str(HP_EPOCHS), "--dropout", "0", "--halo_hub", str(HP_HUB)]


def hp_timed(fn):
    """``fn()``, its wall and the host clock at its start: (result, wall
    s, clock)."""
    clock0, t0 = time.time(), time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0, clock0


def hp_report(tag, timed, paths, shards, num_data, epochs, where=""):
    """One halo pretrain run (``timed``, from :func:`hp_timed`): its wall,
    each rank's start-up marks and its gates (:func:`hp_check`); each
    rank's launches go into ``paths``.  Returns the records."""
    recs, wall, clock0 = timed
    spans = [" / ".join("%.2f" % (t - clock0) for t in
                        [*r.get("start_marks", {}).values(), *r["span"]])
             for r in recs]
    print(f"  {tag}{where}: wall {wall:.2f} s; each rank (imported, joined "
          f"its group, imported the compiler stack and read the call where "
          f"it was prestarted) entered its run, began its first epoch and "
          f"ended at {spans} s from the call", flush=True)
    key = tag.replace(" ", "_").replace("=", "")
    for rank, launches in enumerate(hp_check(tag, recs, shards, num_data,
                                             epochs)):
        paths[f"{key}_rank{rank}"] = launches
    return recs


def hp_beside(ds):
    """Phase halo_pretrain's (b) and (c), run in a thread beside phases
    kg, graph and mp: their ranks are processes of their own, whose
    launches are counted there.  (b) the 2 x 2 grid on
    an eighth of the arxiv graph's nodes, (c) data-parallel
    ``run_pretrain`` at phase pretrain_mb's batches.  Returns each run's
    :func:`hp_timed` and the grid graph's size; phase halo_pretrain
    checks and prints them."""
    nd, shards = HP_GRID
    small = merge_datasets([registry.load_dataset(
        DATASET, feat_dim=FEAT_DIM, seed=SEED, num_nodes=HP_GRID_NODES)])
    cfg = pretrain_cli.make_config(pretrain_cli.parse(
        [*hp_base(), "--epochs", str(HP_GRID_EPOCHS)]))
    out = {"grid_edges": int(small["edge_index"].shape[1])}
    out["grid"] = hp_timed(lambda: launch_halo_pretrain(
        small, cfg, shards, "cuda", world=nd * shards, weights=[1.0],
        hub_size=HP_HUB, record=True, verbose=False))
    del small
    cfg = dataclasses.replace(pretrain_config(FEAT_DIM), batch_size=MB_BATCH,
                              fanout=MB_FANOUT)
    out["dp"] = hp_timed(lambda: launch_dp_pretrain(
        merge_datasets([ds]), cfg, "cuda", world=DP_RANKS, weights=[1.0],
        max_steps=DP_STEPS, verbose=False))
    return out


def halo_pretrain_run(dev, paths, rem, beside):
    """Phase halo_pretrain (module docstring): (a) the pretrain CLI at
    S = 2 (prestarted ranks) and S = 1, their gates and step 1's losses,
    and kernel 1 on rank 1's dropped remote hub tail (``rem``: the future
    of :func:`hp_rem_layout`); (b) the 2 x 2 grid and (c) data-parallel
    ``run_pretrain`` (``beside``: the future of :func:`hp_beside`).
    Returns kernel 1's (max_abs_err, times) on that case."""
    runs = {}
    # the S = 1 reference runs step 1 alone: the one step compared
    for shards, epochs in ((HALO_SHARDS, HP_EPOCHS), (1, 1)):
        argv = [*hp_base(), "--epochs", str(epochs), "--save_every",
                str(epochs), "--halo_shards", str(shards),
                "--pretrain_run_id", f"chip_smoke_hp{shards}_{os.getpid()}"]
        print(f"  python -m stemgnn_tpu_torch.pretrain {' '.join(argv)}",
              flush=True)
        torch.cuda.empty_cache()
        out = {}

        def cli():
            out["recs"], out["root"] = pretrain_cli.main(argv, record=True)
            return out["recs"]
        try:
            runs[shards] = hp_report(f"halo_pretrain S={shards}",
                                     hp_timed(cli), paths, shards, 1, epochs)
        finally:
            if "root" in out:
                remove_run_dir(out["root"])
    step1 = {s: r[0]["history"][0]["losses"] for s, r in runs.items()}
    for k in HP_SAME:
        a, b = step1[HALO_SHARDS][k], step1[1][k]
        if abs(a - b) > HALO_LOSS_RTOL * abs(b):
            raise AssertionError(f"step 1's {k} at S={HALO_SHARDS} {a} vs "
                                 f"S=1 {b}")
    print(f"  step 1 at S={HALO_SHARDS} against S=1: " + ", ".join(
        f"{k} {step1[HALO_SHARDS][k]:.6f} / {step1[1][k]:.6f}"
        for k in sorted(step1[1])), flush=True)
    del runs
    lay_rem, x, table, view, host_s = rem.result().pop()
    print(f"  rank 1's remote layout, built here beside the S = "
          f"{HALO_SHARDS} run in {host_s:.2f} s of host: "
          f"{describe_layout(lay_rem)}", flush=True)
    case = launch_case("kernel 1 on rank 1's dropped remote tail (layer 1 "
                       "forward)", K1, "halo_pretrain_rem",
                       hp_rem_call(lay_rem, x, table, view))
    del lay_rem, x, view
    torch.cuda.empty_cache()

    # (b) the 2 x 2 grid and (c) data-parallel, run beside phases kg,
    # graph and mp
    side = beside.result()
    nd, shards = HP_GRID
    where = " (run beside phases kg, graph and mp)"
    print(f"  the {nd} x {shards} grid: {HP_GRID_NODES} nodes, "
          f"{side['grid_edges']} edges, {HP_GRID_EPOCHS} epochs", flush=True)
    hp_report("halo_pretrain grid", side["grid"], paths, shards, nd,
              HP_GRID_EPOCHS, where)
    recs, wall, _ = side["dp"]
    if len({r["digest"] for r in recs}) != 1:
        raise AssertionError("data-parallel parameters differ across ranks")
    for rec in recs:
        h = rec["history"][0]
        mb_check_losses(f"data-parallel rank {rec['rank']}", rec["history"],
                        DP_STEPS)
        print(f"  data-parallel rank {rec['rank']}{where}: backend "
              f"{rec['backend']} on {rec['device']}; device "
              f"{h['device_ms']:.3f} ms a step (CUDA events), wall "
              f"{h['epoch_s'] * 1e3 / DP_STEPS:.3f} ms a step, idle share "
              f"{h['idle']:.4f}, sampler {h['host/sample_ms']:.3f} ms a "
              f"step, peak {rec['peak_gb']:.2f} GB", flush=True)
        # no layout on this path (module docstring of
        # parallel.data_parallel): the rank's counts, zeroed just before
        # its run, stay 0
        expect_counts(f"data-parallel rank {rec['rank']}", rec["launches"],
                      {})
        paths[f"data_parallel_rank{rec['rank']}"] = {
            k: rec["launches"].get(k, 0) for k in (K1, K2, K3)}
    print(f"  data-parallel: {DP_RANKS} ranks x {DP_STEPS} steps in "
          f"{wall:.2f} s with set-up; parameters bit-equal across ranks",
          flush=True)
    return case


# ------------------------------------------------------------ phase ofa

def ofa_report(tag, st, paths, path):
    """One OFA part's lines from ``ofa_train_eval``'s stats: samples/s,
    host ms a batch, device ms a step, idle share, peak GB, first and last
    loss; its kernel launches read into ``paths[path]`` and gated at 0."""
    paths[path] = read_counts()
    expect_counts(tag, paths[path], {})
    host = st["host_ms"] + st["eval_host_ms"]
    busy_ms = sum(st["step_ms"]) + sum(st["eval_ms"])
    losses = st["losses"]
    print(f"  {tag}: {st['samples'] / st['wall_s']:.1f} samples/s "
          f"({st['samples']} in {st['wall_s']:.2f} s); host "
          f"{np.mean(host):.2f} ms a batch of {len(host)} (sample, prompt, "
          f"collate, copy); device {np.mean(st['step_ms']):.3f} ms a step "
          f"of {len(st['step_ms'])}, {np.mean(st['eval_ms']):.3f} ms an "
          f"evaluation batch (CUDA events); idle share "
          f"{1.0 - busy_ms / (st['wall_s'] * 1e3):.4f}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}", flush=True)
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: losses {losses}")


def ofa_check_metric(tag, name, value):
    print(f"  {tag}: {name} {value:.6f}", flush=True)
    if not 0.0 <= value <= 1.0:
        raise AssertionError(f"{tag}: {name} {value}")


def ofa_grads(model, loss_fn):
    model.train()
    loss = loss_fn(model)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().float().cpu()
                                  for n, p in model.named_parameters()
                                  if p.grad is not None}


def ofa_gate(tag, model0, loss_fn, batch_cpu, batch_card, pool):
    """The card against the CPU on one batch (``batch_cpu`` and its copy
    on the card) from the same initial weights, drawn on the CPU: the loss
    within 1e-4 relative and every gradient within 2% of the largest.  The
    CPU's side runs in ``pool``, beside the card's run; returns a callable
    that checks."""
    cpu_side = pool.submit(ofa_grads, copy.deepcopy(model0),
                           lambda m: loss_fn(m, batch_cpu))
    dev = (batch_card.g if hasattr(batch_card, "g")
           else batch_card[0]).node_feat.device
    card_loss, card_g = ofa_grads(copy.deepcopy(model0).to(dev),
                                  lambda m: loss_fn(m, batch_card))

    def check():
        cpu_loss, cpu_g = cpu_side.result()
        err = abs(card_loss - cpu_loss) / max(abs(cpu_loss), 1e-30)
        print(f"  {tag}: a batch's loss on the card {card_loss:.7f}, on the "
              f"CPU {cpu_loss:.7f} (relative {err:.2e}, gate 1e-4)",
              flush=True)
        if err > 1e-4 or not np.isfinite(card_loss):
            raise AssertionError(f"{tag}: the card's loss disagrees")
        check_grads(f"{tag} (card against CPU)", card_g, cpu_g)
    return check


def ofa_batch_to(b, dev):
    """An ``ofa.train.Batch`` with its tensors on ``dev``."""
    return b._replace(g=graph_to_device(b.g, dev),
                      valid=b.valid.to(dev), labels=b.labels.to(dev),
                      true_mask=b.true_mask.to(dev))


def ofa_bce(model, b):
    return ofa_train.bce_loss(model(b.g), b.valid, b.labels)


def ofa_part(tag, path, dataset, train_idx, eval_idx, kind, dev, paths,
             pool, task="single", batch_size=OFA_BATCH):
    """``ofa_train_eval`` at full width for one epoch from initial weights
    drawn on the CPU, with the card-against-CPU gate on a batch of
    ``OFA_GATE`` samples of the same dataset; returns the gate's check."""
    model0 = ofa_train.OFAModel(kind, 2, FEAT_DIM,
                                generator=torch.Generator().manual_seed(SEED))
    gate_batch = ofa_train.make_batches(
        dataset, np.asarray(train_idx[:OFA_GATE]), OFA_GATE)[0]
    check = ofa_gate(tag, model0, ofa_bce, gate_batch,
                     ofa_batch_to(gate_batch, dev), pool)
    torch.cuda.reset_peak_memory_stats()
    st = {}
    reset_counts()
    loss, metric = ofa_train.ofa_train_eval(
        dataset, train_idx, eval_idx, dim=FEAT_DIM, kind=kind, epochs=1,
        batch_size=batch_size, seed=SEED, task=task, device=dev,
        model=copy.deepcopy(model0), stats=st)
    ofa_report(tag, st, paths, path)
    ofa_check_metric(tag, "AUC" if task == "multi" else "accuracy", metric)
    return check


def ofa_head_batch(chunk):
    """A collated batch of prompted samples with each sample's RWPE
    (walks of ``OFA_WALK``) stacked below one another: (graph, aux, pe,
    labels), on the host."""
    tot_n = sum(len(s["node_feat"]) for s in chunk)
    tot_e = sum(len(s["senders"]) for s in chunk)
    g, aux = ofa_prompt.collate_prompted(
        chunk, node_pad_to=round_up(tot_n + 1, 1024),
        edge_pad_to=round_up(tot_e, 4096))
    pe = np.zeros((g.num_nodes_padded, OFA_WALK), np.float32)
    pe[:tot_n] = np.concatenate([ofa_heads.random_walk_pe(
        s["senders"], s["receivers"], len(s["node_feat"]), OFA_WALK)
        for s in chunk])
    return g, aux, torch.from_numpy(pe), np.asarray([s["y"] for s in chunk])


def ofa_head_loss(head, b):
    g, aux, pe, _ = b
    s = ofa_heads.bin_graph_apply(head, g, aux, rwpe=pe)
    valid = torch.as_tensor(aux["bin_valid"], device=s.device)
    s = torch.where(valid, s, torch.zeros((), device=s.device))
    return ofa_train.bce_loss(s, valid, torch.as_tensor(
        aux["bin_labels"], device=s.device))


def ofa_head_run(dataset, dev, paths, pool):
    """(e): ``BinGraphHead`` with attention pooling and RWPE,
    ``OFA_HEAD_STEPS`` AdamW steps on batches of the node task, then its
    accuracy on them in evaluation."""
    tag = "ofa (e) head (att_pool, RWPE)"
    host_ms, chunks, batches = [], [], []
    for i in range(OFA_HEAD_STEPS):
        t0 = time.perf_counter()
        chunks.append([dataset[j] for j in range(i * OFA_BATCH,
                                                 (i + 1) * OFA_BATCH)])
        g, aux, pe, ys = ofa_head_batch(chunks[-1])
        batches.append((graph_to_device(g, dev), aux, pe.to(dev), ys))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    head0 = ofa_heads.BinGraphHead(
        "gine", 2, FEAT_DIM, FEAT_DIM, att_pool=True, walk_length=OFA_WALK,
        generator=torch.Generator().manual_seed(SEED))
    g, aux, pe, ys = ofa_head_batch(chunks[0][:OFA_GATE])
    check = ofa_gate(tag, head0, ofa_head_loss, (g, aux, pe, ys),
                     (graph_to_device(g, dev), aux, pe.to(dev), ys), pool)
    head = copy.deepcopy(head0).to(dev).train()
    opt = Optimizer(head.parameters(), 1e-3)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    events, losses = [], []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        opt.zero_grad()
        loss = ofa_head_loss(head, b)
        loss.backward()
        opt.step()
        stop.record()
        events.append((start, stop))
        losses.append(loss.detach())
    head.eval()
    correct = total = 0
    with torch.no_grad():
        for g, aux, pe, ys in batches:
            s = ofa_heads.bin_graph_apply(head, g, aux, rwpe=pe).cpu().numpy()
            gid = g.node_graph_id.cpu().numpy()
            for i, y in enumerate(ys):
                rows = np.nonzero((gid == i) & aux["true_nodes_mask"])[0]
                correct += int(np.argmax(s[rows]) == y)
                total += 1
    torch.cuda.synchronize()
    st = {"losses": [float(x) for x in losses], "host_ms": host_ms,
          "eval_host_ms": [], "step_ms": [a.elapsed_time(b)
                                          for a, b in events],
          "eval_ms": [0.0],
          "wall_s": time.perf_counter() - t0 + sum(host_ms) / 1e3,
          "samples": OFA_HEAD_STEPS * OFA_BATCH}
    ofa_report(tag, st, paths, "ofa_head")
    ofa_check_metric(tag, "accuracy on its batches", correct / total)
    return check


def ofa_prepare():
    """Phase ofa's datasets (the CSR adjacencies of the arxiv graph and the
    WN18RR-size KG, the molecules), built beside phase halo_pretrain: no
    sample is drawn here."""
    t0 = time.perf_counter()
    tc = ofa_tasks.TaskConstructor(
        feat_dim=FEAT_DIM, seed=SEED, load_kw={KG: dict(
            num_entities=WN18RR_ENTITIES, num_edges=WN18RR_TRIPLES)})
    node = tc.make_subgraph_dataset(DATASET, "valid")
    ds = tc.get_dataset(DATASET)
    base = ofa_datasets.SubgraphNodeDataset(
        ds, node.class_emb, node.prompt_edge_emb, np.arange(ds.num_nodes),
        seed=SEED)
    kg = tc.make_link_dataset(KG, "train")
    graphs, labels, _ = load_dataset("mol_synthetic", feat_dim=FEAT_DIM,
                                     seed=SEED)
    mols = ofa_datasets.GraphListHierDataset(
        graphs, labels, np.eye(labels.shape[1], FEAT_DIM, dtype=np.float32),
        node.prompt_edge_emb, np.arange(len(graphs)))
    return {"node": node, "base": base, "kg": kg, "mols": mols,
            "labels": np.asarray(ds.labels), "seconds":
            time.perf_counter() - t0}


def ofa_run(dev, paths, prep):
    """Phase ofa (module docstring): the OFA in-context and few-shot path
    at full width, no kernel, on the datasets of :func:`ofa_prepare`.
    Raises on a failed gate."""
    print(f"  datasets and their adjacencies built in {prep['seconds']:.2f} "
          f"s of host beside phase halo_pretrain", flush=True)
    node, kg = prep["node"], prep["kg"]
    checks = []
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # (a) the node task, in context
        n_tr, n_ev = OFA_NODE
        checks.append(ofa_part(
            "ofa (a) node", "ofa_node", node, np.arange(n_tr),
            np.arange(n_tr, n_tr + n_ev), "gine", dev, paths, pool))
        # (b) the KG task at WN18RR's size, rgcn then rgat
        n_tr, n_ev = OFA_KG
        for kind in ("rgcn", "rgat"):
            checks.append(ofa_part(
                f"ofa (b) KG {kind}", f"ofa_kg_{kind}", kg, np.arange(n_tr),
                np.arange(n_tr, n_tr + n_ev), kind, dev, paths, pool))
        # (c) few-shot on arxiv's low-resource class split
        base, labels = prep["base"], prep["labels"]
        lr_split = ofa_tasks.low_resource_class_split("arxiv")
        split = {"train": lr_split["train"], "test": lr_split["test"]}
        n_way, k_shot, n_tr, n_ev = OFA_FS
        tag = f"ofa (c) few-shot {n_way}-way {k_shot}-shot"
        model0 = ofa_train.OFAModel(
            "gine", 2, FEAT_DIM, generator=torch.Generator().manual_seed(SEED))
        pools = ofa_tasks.fewshot_class_pools(labels, split)["train"]
        episodes = ofa_fewshot.FewShotDataset(
            ofa_fewshot.SimpleFSManager(*pools, k_shot=k_shot, q_query=1,
                                        n_way=n_way, seed=SEED + 7),
            base, base, np.stack([np.zeros(FEAT_DIM, np.float32),
                                  np.ones(FEAT_DIM, np.float32)]),
            sample_size=OFA_FS_GATE, seed=SEED + 7)
        gate_batch = ofa_train.make_batches(
            episodes, np.arange(OFA_FS_GATE), OFA_FS_GATE)[0]
        checks.append(ofa_gate(tag, model0, ofa_bce, gate_batch,
                               ofa_batch_to(gate_batch, dev), pool))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        stats = {}
        out = ofa_train.fewshot_train_eval(
            base, labels, split, dim=FEAT_DIM, n_way=n_way, k_shot=k_shot,
            train_episodes=n_tr, eval_episodes=n_ev, epochs=1,
            batch_size=OFA_FS_BATCH, seed=SEED, device=dev, model=model0,
            stats=stats)
        ofa_report(tag, stats["test"], paths, "ofa_fewshot")
        ofa_check_metric(tag, "test accuracy", out["test_acc"])
        # (d) the chem multitask on molecules, NaN labels excluded
        n_tr, n_ev = OFA_MOL
        checks.append(ofa_part(
            "ofa (d) chem multitask", "ofa_chem", prep["mols"],
            np.arange(n_tr), np.arange(n_tr, n_tr + n_ev), "gine", dev,
            paths, pool, task="multi"))
        # (e) the bin-graph head
        checks.append(ofa_head_run(node, dev, paths, pool))
        for check in checks:
            check()


# ---------------------------------------------------- phase edge_parallel

# the v1 edge-partitioned finetune: its ranks, epochs and split, its loss
# gate between S = 2 and S = 1 (phase halo's), and the f32 gate of the
# shards' summed aggregation against the single-device one
EP_SHARDS, EP_EPOCHS = 2, 2
EP_LOSS_RTOL = 1e-3
EP_AGG_RTOL, EP_AGG_ATOL = 1e-4, 1e-5


def ep_config():
    """Phase edge_parallel's configuration: the reference's finetune
    widths (D = 768, 2-layer sage, a 4-head VQ of 128 codes that is not
    initted, so that rank 0 k-means-initializes it), dropout 0, one
    split."""
    base = FinetuneConfig()
    return dataclasses.replace(
        base, encoder=dataclasses.replace(base.encoder, dropout=0.0),
        epochs=EP_EPOCHS, repeat=1, num_classes=NUM_CLASSES)


def ep_report(tag, rec):
    """One rank's measurements of a run of the v1 finetune."""
    hist = rec["history"]
    km = "; ".join(f"k-means init {k['host_s']:.2f} s (the full graph and "
                   f"its layout built first), launches on its layout "
                   f"{k['launches']}" for k in rec["kmeans"]) or \
        "no k-means init (rank 0 runs it and broadcasts the codebook)"
    print(f"  {tag} rank {rec['rank']}: backend {rec['backend']} on "
          f"{rec['device']}; its shard {rec['edges']} edges in "
          f"{rec['edges_shard']} slots, N_pad {rec['n_pad']}; shard build "
          f"{rec['build_s']:.2f} s of host; {km}; per epoch: wall "
          f"{['%.1f' % h['epoch_ms'] for h in hist]} ms, step "
          f"{['%.1f' % h.get('step_ms', 0) for h in hist]} ms, evaluation "
          f"{['%.1f' % h.get('eval_ms', 0) for h in hist]} ms, "
          f"all-reduces a step {[h['step_allreduces'] for h in hist]} "
          f"taking {['%.1f' % h['step_allreduce_ms'] for h in hist]} ms, "
          f"an evaluation {[h['eval_allreduces'] for h in hist]} taking "
          f"{['%.1f' % h['eval_allreduce_ms'] for h in hist]} ms (CUDA "
          f"events), idle share {[h['idle'] for h in hist]}; peak "
          f"{rec['peak_gb']:.2f} GB; losses "
          f"{[h['losses']['loss'] for h in hist]}; accuracies "
          f"{[h['accs'] for h in hist]}; launches {rec['launches']}",
          flush=True)


def ep_gates(ds, cfg, dev):
    """In this process, at S = 1 on the card: the two shards' sums of
    ``sharded_sage_aggregate`` (summed here, not over ranks) against
    the single-device ``gather_scatter_aggregate``, sum and mean; then
    one training step of ``make_edge_parallel_steps`` stamped by a
    ``DeviceTimer`` against its CUDA events (the stamp waits for the
    step)."""
    one = mesh.Ranks(rank=0, world=1, device=dev, backend="none")
    sg = prepare_sharded_graph(ds, one)
    n_pad = sg.n_pad
    ei = np.asarray(ds.edge_index)
    parts = partition_edges_by_destination(
        ei[0].astype(np.int32), ei[1].astype(np.int32), EP_SHARDS)
    with torch.no_grad():
        total = deg = 0.0
        for i in range(EP_SHARDS):
            s, r, m = (torch.from_numpy(parts[k][i]).to(dev) for k in (
                "senders", "receivers", "edge_mask"))
            total = total + sharded_sage_aggregate(
                sg.node_feat, s.long(), r.long(), m, sg.edge_feat,
                ranks=None, reduce="sum")
            deg = deg + torch.zeros(n_pad, device=dev).index_add_(
                0, r.long(), m.float())
        got = {"sum": total, "mean": total / deg.clamp(min=1.0)[:, None]}
        del total
        for reduce in ("sum", "mean"):
            want = gather_scatter_aggregate(
                sg.node_feat, sg.senders, sg.receivers,
                edge_feat=sg.edge_feat, edge_mask=sg.edge_mask,
                reduce=reduce)
            check_close(f"{EP_SHARDS} shards' summed sharded_sage_aggregate "
                        f"({reduce}) vs the single-device "
                        f"gather_scatter_aggregate, E={ds.num_edges} "
                        f"D={FEAT_DIM}", got[reduce], want, EP_AGG_RTOL,
                        EP_AGG_ATOL, what="the sharded aggregation")
            del want
        del got
    model = finetune_loop.task_model_init(
        cfg, generator=torch.Generator().manual_seed(SEED)).to(dev)
    model.vq.initted.fill_(True)        # a random codebook: no k-means
    y = torch.zeros(n_pad, dtype=torch.long, device=dev)
    y[:ds.num_nodes] = torch.from_numpy(np.asarray(ds.labels)).to(dev)
    train_mask = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    train_mask[:ds.num_nodes] = torch.from_numpy(
        np.asarray(ds.splits[0]["train"])).to(dev)
    train_step, _ = make_edge_parallel_steps(cfg, sg, one, y)
    trainable, _ = finetune_loop._split_params(model, cfg)
    opt = finetune_loop.make_optimizer(trainable, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    train_step(model, opt, train_mask, gen)             # the lazy state
    torch.cuda.synchronize()
    timer = DeviceTimer(verbose=False)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    timer.record()
    a.record()
    parts = train_step(model, opt, train_mask, gen)
    b.record()
    stamp_ms = timer.cal_and_update("step", value=parts) * 1e3
    torch.cuda.synchronize()
    event_ms = a.elapsed_time(b)
    print(f"  one S = 1 training step: DeviceTimer {stamp_ms:.1f} ms, CUDA "
          f"events {event_ms:.1f} ms", flush=True)
    if stamp_ms < 0.9 * event_ms:
        raise AssertionError(f"the DeviceTimer stamp ({stamp_ms:.1f} ms) "
                             f"did not wait for the step ({event_ms:.1f} "
                             f"ms)")


def ep_launch(ds, shards):
    """``launch_edge_parallel_finetune`` of phase edge_parallel's
    configuration on ``shards`` ranks: (records, wall s, host clock at the
    call)."""
    t0, clock0 = time.perf_counter(), time.time()
    recs = launch_edge_parallel_finetune(ds, ep_config(), shards, "cuda")
    return recs, time.perf_counter() - t0, clock0


def ep_check_run(shards, run, paths):
    """One run's reports and launch gates: kernel 2 twice on rank 0 (its
    k-means init) and never on another rank, kernels 1 and 3 never."""
    recs, wall, clock0 = run
    if [r["rank"] for r in recs] != list(range(shards)):
        raise AssertionError(f"S={shards}: ranks {[r['rank'] for r in recs]}")
    spans = [" / ".join("%.2f" % (t - clock0) for t in
                        [*r.get("start_marks", {}).values(), *r["span"]])
             for r in recs]
    print(f"  S = {shards}: wall {wall:.2f} s; each rank "
          f"{'(started at phase ofa) imported its modules, joined the '
             'group, imported the compiler stack, read the call, '
             if shards > 1 else ''}entered its run, began its first epoch "
          f"and ended training at {spans} s from the call", flush=True)
    for rec in recs:
        ep_report(f"edge-parallel S={shards}", rec)
        key = f"edge_parallel{shards}_rank{rec['rank']}"
        paths[key] = {k: rec["launches"].get(k, 0) for k in (K1, K2, K3)}
        want = {K2: 2 if rec["rank"] == 0 else 0}
        expect_counts(f"S={shards} rank {rec['rank']} (kernel 2 in rank "
                      f"0's k-means init)", paths[key], want)
        if rec["kmeans"]:
            expect_counts(f"S={shards} rank 0's k-means layout",
                          {k: rec["kmeans"][0]["launches"].get(k, 0)
                           for k in (K1, K2, K3)}, want)


def edge_parallel_run(ds, dev, paths, two):
    """Phase edge_parallel (module docstring): the S = 2 run of
    ``launch_edge_parallel_finetune`` (``two``: the future of
    :func:`ep_launch`, run beside phase ofa with its ranks started there)
    and the S = 1 run in this process with kernel 2's launches recorded,
    the gates, then :func:`ep_gates`.  Returns kernel 2's (max_abs_err,
    times) on each of the S = 1 k-means init's launches."""
    ep_check_run(EP_SHARDS, two.result(), paths)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    calls = []
    real = fused_sage.gathered_scatter_rows_sorted

    def record(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    fused_sage.gathered_scatter_rows_sorted = record
    try:
        one = ep_launch(ds, 1)
    finally:
        fused_sage.gathered_scatter_rows_sorted = real
    here = read_counts()
    ep_check_run(1, one, paths)
    expect_counts("S=1, counted in this process", here, {K2: 2})
    recs = two.result()[0]
    if len({r["digest"] for r in recs}) != 1:
        raise AssertionError(f"the ranks' parameters differ: "
                             f"{[r['digest'] for r in recs]}")
    print(f"  the {EP_SHARDS} ranks' parameters bit-equal after training "
          f"(digest {recs[0]['digest'][:16]})", flush=True)
    want = [h["losses"]["loss"] for h in one[0][0]["history"]]
    for rec in recs:
        losses = [h["losses"]["loss"] for h in rec["history"]]
        if len(losses) != EP_EPOCHS or not all(
                abs(a - b) <= EP_LOSS_RTOL * abs(b)
                for a, b in zip(losses, want)):
            raise AssertionError(f"S={EP_SHARDS} rank {rec['rank']}: "
                                 f"losses {losses} vs S=1 {want}")
    print(f"  losses at S={EP_SHARDS} within {EP_LOSS_RTOL} relative of "
          f"S=1's {want}", flush=True)
    if len(calls) != 2:
        raise AssertionError(f"the S=1 k-means init launched kernel 2 "
                             f"{len(calls)} times")
    cases = {f"edge_parallel_kmeans_l{i + 1}": launch_case(
        f"kernel 2 in the S=1 k-means init's encode, layer {i + 1}", K2,
        f"edge_parallel_kmeans_l{i + 1}", call)
        for i, call in enumerate(calls)}
    del one, calls, recs
    torch.cuda.empty_cache()
    ep_gates(ds, ep_config(), dev)
    return cases


# ------------------------------------------------------------ phase vq

def vq_configs():
    """The VQ training options of phase vq: the cosine codebook with the
    EMA update and dead-code expiry, and a euclidean one with the affine
    statistics and straight-through Gumbel sampling (and the EMA)."""
    base = pretrain_config(FEAT_DIM)
    return {
        "ema": dataclasses.replace(base, vq=dataclasses.replace(
            base.vq, ema_update=True, threshold_ema_dead_code=2.0)),
        "affine_gumbel": dataclasses.replace(base, vq=dataclasses.replace(
            base.vq, use_cosine_sim=False, affine_param=True,
            straight_through_gumbel=True, stochastic_sample_codes=True,
            ema_update=True))}


class DeadCodes:
    """Counts the codes each expiry replaces (``vq.codebook.
    expire_dead_codes``, which the VQ calls through its module)."""

    def __enter__(self):
        self.counts, self.real = [], cb.expire_dead_codes

        def counting(state, embed, xh, *, threshold, **kw):
            if threshold > 0:
                self.counts.append(int((state["cluster_size"]
                                        < threshold).sum()))
            return self.real(state, embed, xh, threshold=threshold, **kw)
        cb.expire_dead_codes = counting
        return self

    def __exit__(self, *exc):
        cb.expire_dead_codes = self.real
        return False


def vq_run(merged, csc, dev, paths):
    """``run_pretrain`` with the VQ's training options, VQ_STEPS steps each
    at full width (phase vq): finite losses, the codebook moved and adopted
    from the EMA target, the EMA cluster sizes moved, dead codes replaced;
    then, for each run, one step on one batch on the card against the CPU
    with the same draws handed to both: the loss within 1e-3 relative, the
    gradients within the step gate and the VQ state after it (the EMA
    sums, cluster sizes, target codebook, replaced dead codes, affine
    statistics) within VQ_STATE_RTOL (:func:`check_vq_state`)."""
    node_table = torch.from_numpy(merged["node_text_feat"]).float()
    edge_table = torch.from_numpy(merged["edge_text_feat"]).float()
    tables = (node_table, edge_table, node_table.to(dev),
              edge_table.to(dev))
    for name, cfg in vq_configs().items():
        cfg = dataclasses.replace(cfg, batch_size=VQ_BATCH, fanout=MB_FANOUT,
                                  fused_minibatch="auto")
        # run_pretrain's own seeded model, built here to keep its codebook
        model = PretrainModel(cfg, generator=torch.Generator().manual_seed(
            cfg.seed))
        init_embed = model.vq.embed.detach().clone()
        reset_counts()
        t0 = time.perf_counter()
        with DeadCodes() as dead:
            model, teacher, hist = run_pretrain(
                merged, cfg, weights=[1.0], max_steps=VQ_STEPS, device=dev,
                verbose=False, model=model)
        paths[f"vq_{name}"] = read_counts()
        expect_counts(f"run_pretrain {name} ({VQ_STEPS} steps, no layout)",
                      paths[f"vq_{name}"], {})
        mb_check_losses(f"run_pretrain {name}", hist, VQ_STEPS)
        vq = model.vq
        moved = float((vq.embed.detach().cpu() - init_embed).abs().max())
        if not torch.equal(vq.embed, vq.embed_target):
            raise AssertionError("the EMA codebook was not adopted")
        sizes = vq.cluster_size.detach().cpu()
        print(f"  {name}: {time.perf_counter() - t0:.2f} s; codebook "
              f"|change| max {moved:.3e}; cluster sizes {float(sizes.min()):.3f}"
              f"..{float(sizes.max()):.3f} (sum {float(sizes.sum()):.1f}); "
              f"dead codes replaced a step {dead.counts}", flush=True)
        expiry = cfg.vq.threshold_ema_dead_code > 0
        if not (moved > 0 and float(sizes.sum()) > 0
                and len(dead.counts) == VQ_STEPS * expiry
                and (sum(dead.counts) > 0) == expiry):
            raise AssertionError(f"phase vq {name}: the codebook, its sizes "
                                 f"or its dead codes did not move")
        if cfg.vq.affine_param and not bool(vq.affine_initted):
            raise AssertionError("the affine statistics were not updated")
        vq_card_vs_cpu(name, cfg, model, teacher, merged, csc, tables, dev)
        del model, teacher, vq
        torch.cuda.empty_cache()


def vq_card_vs_cpu(name, cfg, model, teacher, merged, csc, tables, dev):
    """One pretrain step on one batch of VQ_CHECK_BATCH seeds on the card
    and on the CPU, from copies of the same model with the same draws
    (the augmentation's, the VQ's Gumbel noise and dead-code rows)."""
    rng = np.random.default_rng(SEED + 2)
    it = NeighborBatchIterator(
        csc, merged["x"], merged["xe"],
        get_train_node_idx(merged["ptr"], [1.0], rng), VQ_CHECK_BATCH,
        [MB_FANOUT, MB_FANOUT], rng, drop_last=True)
    ig = next(iter(it))[0]
    g_cpu = batch_graph(ig, *tables[:2], torch.device("cpu"), False)
    g_dev = batch_graph(ig, *tables[2:], dev, False)
    gen = torch.Generator().manual_seed(SEED)
    draws = draw_step(cfg, g_cpu, gen)
    h = cfg.vq.num_codebooks
    draws["vq_gumbel"] = cb.gumbel_noise(
        (h, g_cpu.num_nodes_padded, cfg.vq.codebook_size), gen)
    draws["vq_expire"] = cb.sample_indices(
        h, g_cpu.num_nodes_padded, cfg.vq.codebook_size, g_cpu.node_mask,
        gen)
    out = {}
    for where, g in (("cpu", g_cpu), ("card", g_dev)):
        d = {k: (tuple(t.to(g.node_feat.device) for t in v)
                 if isinstance(v, tuple) else
                 None if v is None else v.to(g.node_feat.device))
             for k, v in draws.items()}
        # dropout 0 on both sides: the draws of the masks are the device's
        m = copy.deepcopy(model).to(g.node_feat.device)
        t = copy.deepcopy(teacher).to(g.node_feat.device)
        for enc in (m.encoder, t):
            enc.cfg = dataclasses.replace(enc.cfg, dropout=0.0)
        with DeadCodes() as dead:
            loss, _, aux = pretrain_forward(
                m, t, cfg, augmented(cfg, g, d), g, bs=VQ_CHECK_BATCH,
                draws=d, drop_seed=d["drop_seed"])
        loss.backward()
        out[where] = ({k: p.grad.cpu() for k, p in m.named_parameters()
                       if p.grad is not None},
                      {k: v.detach().cpu() for k, v in
                       m.vq.state_dict().items()}, float(loss.detach()),
                      aux["vq"]["indices"][g.node_mask].cpu(), dead.counts)
    rel = abs(out["card"][2] - out["cpu"][2]) / abs(out["cpu"][2])
    print(f"  {name}: one step on a batch of {ig.n_node} nodes, loss card "
          f"{out['card'][2]:.6f} / CPU {out['cpu'][2]:.6f} ({rel:.2e} "
          f"relative); dead codes replaced card {out['card'][4]} / CPU "
          f"{out['cpu'][4]}", flush=True)
    if rel > 1e-3:
        raise AssertionError(f"phase vq {name}: the card's loss is not the "
                             f"CPU's")
    check_grads(f"the CPU ({name}, the same draws)", out["card"][0],
                out["cpu"][0])
    check_vq_state(name, cfg.vq, out["card"][1], out["cpu"][1],
                   out["card"][3], out["cpu"][3])
    if cfg.vq.threshold_ema_dead_code > 0 and not out["cpu"][4][0]:
        raise AssertionError(f"phase vq {name}: the checked step replaced "
                             f"no dead code")


def check_vq_state(name, vq_cfg, card, cpu, codes_card, codes_cpu):
    """The VQ state after one step on the card against the CPU's: every
    floating entry within VQ_STATE_RTOL of its largest magnitude on the
    CPU.  The per-code entries ([num_codebooks, C, ...]: the codebook, the
    EMA sums and cluster sizes, the target codebook) only on the codes no
    node moved to or from between the devices (``codes_*`` [n, heads], a
    node at an f32 near-tie may take another code); the affine statistics
    whole."""
    h, c = vq_cfg.num_codebooks, vq_cfg.codebook_size
    a, b = codes_card.reshape(-1, h), codes_cpu.reshape(-1, h)
    same = torch.ones(h, c, dtype=torch.bool)
    for head in range(h):
        moved = a[:, head] != b[:, head]
        same[head, a[moved, head]] = False
        same[head, b[moved, head]] = False
    errs = {}
    for k, want in cpu.items():
        if not want.is_floating_point():
            continue
        got = card[k]
        if want.shape[:2] == (h, c):
            got, want = got[same], want[same]
        errs[k] = max_err(got, want)
        if errs[k] > VQ_STATE_RTOL * float(want.abs().max()):
            raise AssertionError(f"phase vq {name}: the card's {k} is "
                                 f"{errs[k]:.3e} from the CPU's")
    print(f"  {name}: the VQ state after the step, max |card - CPU| "
          f"(within {VQ_STATE_RTOL:.0e} of each entry's largest; per code "
          f"on the {int(same.sum())} of {h * c} codes whose nodes agree): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)


def kg_encode_run(tmp, dev, paths):
    """``infer.main --mode encode`` from phase slice's checkpoint on the
    cached WN18RR (one edge text) and on ``kg_synthetic`` (11 edge types:
    the typed hub block and kernel 2's xe mode), on the card and on the
    CPU's layout route: kernel 2 once a layer, ``z`` against the CPU's
    within the ``z`` gates, the quantized rows where the codes agree
    likewise, and the codes' agreement printed."""
    for name in ("WN18RR", KG):
        out = os.path.join(tmp, f"encode_{name}.npz")
        argv = ["--finetune_dataset", name, "--feat_dim", str(FEAT_DIM),
                "--pretrain_path", tmp, "--pretrain_model_epoch", "50",
                "--seed", str(SEED), "--out", out]
        print(f"  python -m stemgnn_tpu_torch.infer {' '.join(argv)}",
              flush=True)
        reset_counts()
        t0 = time.perf_counter()
        infer_main(argv)
        paths[f"encode_{name}"] = read_counts()
        wall = time.perf_counter() - t0
        expect_counts(f"encode {name}", paths[f"encode_{name}"], {K2: 2})
        card = {k: torch.from_numpy(v) for k, v in np.load(out).items()}
        # the CPU on the same layout route (bf16 messages through the
        # kernels' plain versions), so that only the sums' order differs
        layout_applies = graph_setup._layout_applies
        graph_setup._layout_applies = lambda cfg, device: True
        t0 = time.perf_counter()
        try:
            infer_main([*argv, "--device", "cpu"])
        finally:
            graph_setup._layout_applies = layout_applies
        cpu_s = time.perf_counter() - t0
        cpu = {k: torch.from_numpy(v) for k, v in np.load(out).items()}
        n = cpu["embeddings"].shape[0]
        if not all(torch.isfinite(card[k]).all() for k in ("embeddings",
                                                           "quantized")):
            raise AssertionError(f"encode {name}: non-finite outputs")
        check_z(f"encode {name} on the CPU", card["embeddings"],
                cpu["embeddings"], n)
        same = (card["codes"] == cpu["codes"]).all(1)
        check_z(f"encode {name} quantized rows on the CPU (codes equal)",
                card["quantized"][same], cpu["quantized"][same],
                int(same.sum()))
        print(f"  encode {name}: {n} nodes, card wall {wall:.2f} s, CPU "
              f"{cpu_s:.2f} s; code rows equal on both: "
              f"{float(same.float().mean()):.6f}", flush=True)


def save_checkpoint(tmp, gen, moe: bool = False):
    """A JAX-format pretrain checkpoint with random weights and non-trivial
    BatchNorm statistics, and its config.json; with ``moe`` an MoE-SAGE
    last layer of 3 experts with its router (``--moe --moe_layers last``).
    Returns the encoder and VQ parameters as saved."""
    moe_kw = dict(moe=True, moe_layers="last", num_experts=3) if moe else {}
    ecfg = EncoderConfig(input_dim=FEAT_DIM, hidden_dim=FEAT_DIM,
                         num_layers=2, normalize="batch", dropout=0.0,
                         **moe_kw)
    vcfg = VQConfig(dim=FEAT_DIM, codebook_size=128, codebook_dim=FEAT_DIM,
                    heads=4)
    enc = Encoder(ecfg, generator=gen).eval()
    with torch.no_grad():
        for bn in enc.norms:
            bn.mean.normal_(0.0, 0.1, generator=gen)
            bn.var.uniform_(0.5, 1.5, generator=gen)
    params, state = to_jax_pytree(enc, VectorQuantize(vcfg, generator=gen))
    save_pytree(os.path.join(tmp, "encoder_50.npz"),
                {"params": params["encoder"], "state": state["encoder"]})
    save_pytree(os.path.join(tmp, "vq_50.npz"),
                {"params": params["vq"], "state": state["vq"]})
    with open(os.path.join(tmp, "config.json"), "w") as f:
        json.dump({"encoder": {"hidden_dim": FEAT_DIM, "num_layers": 2,
                               "backbone": "sage", "normalize": "batch",
                               **moe_kw},
                   "vq": {"codebook_size": 128, "codebook_dim": FEAT_DIM,
                          "heads": 4}}, f)
    return params


def check_encode_outputs(out, n):
    with np.load(out) as f:     # each array read from the file once
        got = dict(f)
    shapes = {k: v.shape for k, v in got.items()}
    print(f"  outputs {shapes}", flush=True)
    want = {"embeddings": (n, FEAT_DIM), "quantized": (n, FEAT_DIM),
            "codes": (n, 4)}
    if n != 169_343 or shapes != want:
        raise AssertionError(f"output shapes {shapes} != {want}")
    for k in ("embeddings", "quantized"):
        if not np.isfinite(got[k]).all():
            raise AssertionError(f"non-finite values in {k}")
    codes = got["codes"]
    if codes.min() < 0 or codes.max() >= 128:
        raise AssertionError(f"codes outside [0, 128): {codes.min()}.."
                             f"{codes.max()}")
    print(f"  codes in [{codes.min()}, {codes.max()}], "
          f"{len(np.unique(codes))} distinct", flush=True)


def check_z(tag, z, want, n):
    check_close(f"z vs {tag}", z[:n], want[:n], Z_RTOL, Z_ATOL,
                what="z through the kernels")


def step_grads(model, loss_fn, mask, graph, y, plain=False):
    """One training step's gradients of a copy of ``model`` (BatchNorm
    statistics of the original untouched), dropout from a fresh seeded
    generator so every route draws the same masks; parameters the loss does
    not reach (BatchNorm's under normalize "none") have none."""
    m = copy.deepcopy(model)
    gen = torch.Generator(device=graph.node_feat.device).manual_seed(7)
    loss, _ = loss_fn(m, mask, graph, y, gen, plain)
    loss.backward()
    return {k: p.grad for k, p in m.named_parameters()
            if p.requires_grad and p.grad is not None}


def check_grads(tag, got, want):
    scale = max(float(g.abs().max()) for g in want.values())
    worst = max(max_err(got[k], want[k]) for k in want)
    print(f"  step gradients vs {tag}: worst max_abs_err {worst:.3e} over "
          f"{len(want)} tensors (largest gradient {scale:.3e}, tol "
          f"{GRAD_RTOL} of it)", flush=True)
    if set(got) != set(want) or worst > GRAD_RTOL * scale:
        raise AssertionError(f"gradients disagree with {tag}")


def bound_ms(nbytes, flops):
    b, f = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return max(b, f), ("bytes" if b >= f else "operations")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    paths = {}                                      # path -> launch counts
    shared = contextlib.ExitStack()
    graphs = shared.enter_context(shared_datasets())

    with phase("device"):
        card = card_line()
        print(f"  card: {card}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
              flush=True)

    # datasets generated on the host beside phases that wait on nvcc or on
    # the card: the arxiv graph beside the build, the evaluations' graph
    # beside phase pretrain (both through the shared registry)
    prefetch = shared.enter_context(concurrent.futures.ThreadPoolExecutor(1))
    # the compiler stack that the first optimizer (phase train's) imports
    warm = shared.enter_context(concurrent.futures.ThreadPoolExecutor(1))
    compiler = warm.submit(importlib.import_module, "torch._dynamo")
    # the process every rank is forked from imports the same beside it
    mesh.warm_up()
    with phase("build"):
        arxiv = prefetch.submit(load_dataset, DATASET, feat_dim=FEAT_DIM,
                                seed=SEED)
        t0 = time.perf_counter()
        sc.build(force=True)
        print(f"  {len(sc.KERNELS)} kernels built in "
              f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in "
              f"parallel)", flush=True)
        for name in (K1, K2, K3):
            info = sc.build_info[name]
            with open(info["path"] + ".ptxas.log", "w") as f:
                f.write(info["log"])
            print(f"  {name}: {info['seconds']:.2f} s ({info['path']}; "
                  f"the compiler's report beside it, .ptxas.log)\n"
                  f"{ptxas_summary(info['log'])}", flush=True)
            sc.load_library(name)

    with phase("kernel"):
        kernel1_small_cases(dev)
        ds = arxiv.result()
        cfg = FinetuneConfig()
        t0 = time.perf_counter()
        graph = fused_full_graph(ds, cfg, device=dev)    # shared: see slice
        graph_s = time.perf_counter() - t0
        print(f"  full graph and layout built in {graph_s:.2f} s of host; "
              f"{describe_layout(graph.layout)}", flush=True)
        k1_cases, k2_cases = arxiv_tail_cases(graph)
        errs = {}
        for direction, (args, kw, plan) in k1_cases.items():
            p = plan["plan"]
            print(f"  row plan of the {direction} tail: {p.num_items} items "
                  f"of at most {p.chunk} edges, {p.num_split} split rows "
                  f"over {p.num_slots} items", flush=True)
            errs[(K1, direction)] = check_kernel(
                f"kernel 1 arxiv {direction} tail E_pad="
                f"{args['m'].shape[0]} D={FEAT_DIM}",
                sc.scatter_rows_sorted(**args, **kw, **plan),
                sc.scatter_rows_sorted_ref(**args, **kw), torch.float32)

    with phase("kernel2"):
        # phase slice's gwin=off graph, built beside this phase and kernel3
        off_graph = prefetch.submit(fused_full_graph, ds, cfg, device=dev,
                                    gwin="off")
        kernel2_small_cases(dev)
        for direction, (args, kw, plan) in k2_cases.items():
            p = plan["plan"]
            print(f"  row plan of the {direction} tail: {p.num_items} items "
                  f"of at most {p.chunk} edges, {p.num_split} split rows "
                  f"over {p.num_slots} items", flush=True)
            errs[(K2, direction)] = check_kernel(
                f"kernel 2 arxiv {direction} tail E_pad="
                f"{args['keys'].shape[1]} D={FEAT_DIM}",
                sc.gathered_scatter_rows_sorted(**args, **kw, **plan),
                sc.gathered_scatter_rows_sorted_ref(**args, **kw),
                torch.float32)

    with phase("kernel3"):
        kernel3_small_cases(dev)
        typed_errs, typed_times = kernel3_arxiv(ds, dev)

    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    with phase("slice"):
        ckpt_params = save_checkpoint(tmp, torch.Generator().manual_seed(SEED))
        out = os.path.join(tmp, "out.npz")
        argv = ["--finetune_dataset", DATASET, "--feat_dim", str(FEAT_DIM),
                "--pretrain_path", tmp, "--pretrain_model_epoch", "50",
                "--seed", str(SEED), "--out", out]
        print(f"  python -m stemgnn_tpu_torch.infer {' '.join(argv)}",
              flush=True)
        reset_counts()
        t0 = time.perf_counter()
        res = infer_main(argv)
        paths["encode"] = read_counts()
        encode_wall_s = time.perf_counter() - t0
        print(f"  encode wall {encode_wall_s:.2f} s, and the build of the "
              f"full graph and layout it reads ({graph_s:.2f} s, phase "
              f"kernel)", flush=True)
        expect_counts("encode (default layout)", paths["encode"],
                      {K1: 0, K2: 2})
        n = res["num_nodes"]
        check_encode_outputs(out, n)

        encoder, quantizer, z = res["encoder"], res["quantizer"], res["z"]
        g = res["graph"]
        graph_off = off_graph.result()
        del off_graph           # its result, freed in phase train
        print(f"  gwin=off {describe_layout(graph_off.layout)}", flush=True)

        def encode(gr, plain=False):
            return encoder(gr.node_feat, gr.senders, gr.receivers,
                           layout=gr.layout, edge_table=gr.edge_table,
                           plain=plain)
        with torch.no_grad():
            reset_counts()
            z_off = encode(graph_off)
            paths["encode_gwin_off"] = read_counts()
            expect_counts("encode (gwin=off layout)",
                          paths["encode_gwin_off"], {K1: 2, K2: 0})
            check_z("z on gwin=off layouts (kernel 1)", z, z_off, n)
            check_z("z through the plain versions", z, encode(g, plain=True),
                    n)
            same = float((quantizer(z_off)["indices"][:n]
                          == res["vq"]["indices"][:n]).all(1).float().mean())
            print(f"  code rows equal on both routes: {same:.6f}", flush=True)
            fwd_ms = cuda_ms(lambda: quantizer(encode(g)), 5)
            fwd_off_ms = cuda_ms(lambda: quantizer(encode(graph_off)), 5)
        print(f"  encoder+VQ forward on the card: {fwd_ms:.3f} ms (kernel "
              f"2 tails), {fwd_off_ms:.3f} ms (gwin=off: gather + kernel 1)",
              flush=True)
        del res, z, z_off, g

    with phase("train"):
        compiler.result()
        # dropout 0: the run is phase halo's single-device reference too
        argv = ["--finetune_dataset", DATASET, "--feat_dim", str(FEAT_DIM),
                "--pretrain_path", tmp, "--pretrain_model_epoch", "50",
                "--seed", str(SEED), "--epochs", str(EPOCHS), "--repeat", "1",
                "--dropout", "0"]
        print(f"  python -m stemgnn_tpu_torch.finetune {' '.join(argv)}",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = finetune_main(argv)
        paths["finetune"] = read_counts()
        train_wall_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"  finetune wall {train_wall_s:.2f} s ({EPOCHS} epochs); "
              f"per-epoch wall {['%.3f' % s for s in res['epoch_s']]} s; "
              f"peak device memory {peak_gb:.2f} GB", flush=True)
        expect_counts(f"finetune ({EPOCHS} x (train step + eval))",
                      paths["finetune"], {K1: 0, K2: EPOCHS * (3 + 2)})
        losses = [e["loss"] for e in res["epoch_losses"]]
        print(f"  losses {losses}", flush=True)
        if len(losses) != EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f"losses {losses}")
        with torch.no_grad():
            res["model"].eval()
            halo_ref = (argv, losses, task_encode(
                res["model"], res["graph"])[:res["graph"].n_node].float()
                .cpu())

        model, gt, y, mask = (res["model"], res["graph"], res["y"],
                              res["train_mask"])
        loss_fn, train_step, eval_step = res["steps"]
        def saved(part, name):
            want = ckpt_params[part]
            for key in name.split("."):
                want = want[int(key)] if key.isdigit() else want[key]
            return torch.from_numpy(want)
        for name, p in model.encoder.named_parameters():
            if torch.equal(p.detach().cpu(), saved("encoder", name)):
                raise AssertionError(f"encoder.{name} did not change")
        dec0 = Linear(FEAT_DIM * 4, NUM_CLASSES * 4,
                      generator=torch.Generator().manual_seed(0))
        if torch.equal(model.decoder.w.detach().cpu(), dec0.w.detach()):
            raise AssertionError("the decoder did not change")
        for name, p in model.vq.named_parameters():
            if not torch.equal(p.detach().cpu(), saved("vq", name)):
                raise AssertionError(f"the frozen vq.{name} changed")
        print("  every encoder parameter and the decoder moved; the VQ did "
              "not", flush=True)

        reset_counts()
        g_kernel = step_grads(model, loss_fn, mask, gt, y)
        expect_counts("one training step", read_counts(), {K1: 0, K2: 3})
        reset_counts()
        eval_step(model, gt)
        expect_counts("one evaluation", read_counts(), {K1: 0, K2: 2})
        check_grads("the plain versions",
                    g_kernel, step_grads(model, loss_fn, mask, gt, y,
                                         plain=True))
        reset_counts()
        g_off = step_grads(model, loss_fn, mask, graph_off, y)
        expect_counts("one training step on gwin=off layouts", read_counts(),
                      {K1: 3, K2: 0})
        check_grads("the gwin=off route (kernel 1 with the gate)", g_kernel,
                    g_off)
        opt = torch.optim.AdamW([p for p in model.parameters()
                                 if p.requires_grad], lr=1e-3,
                                weight_decay=0.01)
        gen = torch.Generator(device=dev).manual_seed(0)
        step_ms = cuda_ms(lambda: train_step(model, opt, mask, gt, y, gen), 5)
        eval_ms = cuda_ms(lambda: eval_step(model, gt), 5)
        step_off_ms = cuda_ms(
            lambda: train_step(model, opt, mask, graph_off, y, gen), 5)
        print(f"  training step {step_ms:.3f} ms (gwin=off route "
              f"{step_off_ms:.3f} ms), evaluation {eval_ms:.3f} ms, by CUDA "
              f"events", flush=True)
        # the steps' closures and the optimizer hold the model and its
        # graph: nothing of this phase stays on the card
        del res, model, gt, graph_off, loss_fn, train_step, eval_step, opt
        del g_kernel, g_off, mask, y, gen
        torch.cuda.empty_cache()

    with phase("pretrain"):
        ood_ds = prefetch.submit(load_dataset, OOD_DATASET,
                                 feat_dim=FEAT_DIM, seed=SEED)
        k1_drop_cases = pretrain_run(graph, dev, paths, errs)

    with phase("pretrain_mb"):
        t0 = time.perf_counter()
        lib = native_sampler.build(force=True)
        native_sampler.load()
        print(f"  native sampler built from the port's copy of its source "
              f"in {time.perf_counter() - t0:.2f} s ({lib})", flush=True)
        pretrain_mb_cli(ds, tmp, dev, paths)
        mb_merged, mb_csc = pretrain_mb_run(ds, dev, paths)

    with phase("vq"):
        vq_run(mb_merged, mb_csc, dev, paths)
        del mb_merged, mb_csc

    with phase("typed"):
        k3_path = typed_run(tmp, dev, paths)

    # phase halo_pretrain's grid and data-parallel runs, beside phases kg,
    # graph and mp
    beside = shared.enter_context(concurrent.futures.ThreadPoolExecutor(1))
    with phase("ood"):
        ood_ds.result()
        k2_ood = ood_run(tmp, dev, paths)

    with phase("kg"):
        hp_side = beside.submit(hp_beside, ds)
        k2_kg = kg_run(tmp, dev, paths)
        kg_encode_run(tmp, dev, paths)

    with phase("graph"):
        graph_run(tmp, dev, paths)

    with phase("mp"):
        mp_cases = {}
        mp_step_run(graph, dev, paths, mp_cases)
        mp_minibatch_run(ds, dev, paths)
        mp_finetune_run(tmp, dev, paths, mp_cases)
        mp_graph_run(tmp, dev, paths)

    with phase("times"):
        kernels = [time_cases(K1, {**k1_cases, **k1_drop_cases}),
                   time_cases(K2, k2_cases)]
    # the timed cases' arrays (the arxiv tails' messages) go before the
    # widest phase
    del k1_cases, k2_cases, k1_drop_cases
    torch.cuda.empty_cache()

    with phase("backbones"):
        # the locality phase's dataset and split layouts, phase halo's
        # remote layout and its 2 ranks' start-up: host work beside this
        # phase's device work
        mesh.prestart(HALO_SHARDS, "cuda")
        halo_rem = prefetch.submit(halo_rem_layout, ds, 1, dev)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            split_prep = pool.submit(locality_prepare, dev)
            backbones_run(tmp, graph, dev, paths)
            loc_prep = split_prep.result()
        del split_prep          # its result: the split layouts

    with phase("locality"):
        loc_stray, loc_k1, loc_k2 = locality_run(tmp, dev, paths, loc_prep)
        del loc_prep

    with phase("halo"):
        torch.cuda.empty_cache()
        # phase halo_pretrain's 2 ranks start beside this phase and text
        mesh.prestart(HALO_SHARDS, "cuda")
        k2_halo = halo_run(dev, paths, halo_ref, halo_rem)
    tmp_dir.cleanup()
    del graph
    graphs.clear()
    torch.cuda.empty_cache()

    with phase("text"):
        text_run(dev, paths, card)

    with phase("halo_pretrain"):
        held_line()
        # rank 1's remote layout, built beside the S = 2 run
        hp_rem = prefetch.submit(hp_rem_layout, ds, 1, dev)
        ofa_prep = prefetch.submit(ofa_prepare)
        k1_hp = halo_pretrain_run(dev, paths, hp_rem, hp_side)

    with phase("ofa"):
        # phase edge_parallel's S = 2 run beside this phase (a card that
        # this phase's host work leaves idle), its ranks started here
        mesh.prestart(EP_SHARDS, "cuda")
        ep_two = beside.submit(ep_launch, ds, EP_SHARDS)
        ofa_run(dev, paths, ofa_prep.result())
        del ofa_prep

    with phase("edge_parallel"):
        torch.cuda.empty_cache()
        k2_ep = edge_parallel_run(ds, dev, paths, ep_two)
        del ep_two
    shared.close()
    line = []
    for k in kernels:
        name, fwd, bwd = k["name"], k["fwd"], k["bwd"]
        entry = {
            "name": name, "route": "cuda",
            "source": f"stemgnn_tpu_torch/csrc/{name}.cu",
            "replaces": ("stemgnn_tpu/ops/scatter_pallas.py:252" if name == K1
                         else "stemgnn_tpu/ops/scatter_pallas.py:740"),
            "launches": paths["pretrain"][name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": errs[(name, "fwd")],
            "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
            "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
            "library_ms": fwd["library_ms"],
            "bwd_max_abs_err": errs[(name, "bwd")], "bwd_ms": bwd["ms"],
            "bwd_plain_ms": bwd["plain_ms"], "bwd_bound_ms": bwd["bound_ms"],
            "bwd_library_ms": bwd["library_ms"]}
        if name == K1:
            entry.update(case_fields({"locsplit_stray": loc_k1,
                                      "halo_pretrain_rem": k1_hp}))
            for direction in ("drop_fwd", "drop_bwd"):
                entry.update({f"{direction}_max_abs_err":
                              errs[(name, direction)]})
                entry.update({f"{direction}_{key}": v
                              for key, v in k[direction].items()})
        if name == K2:
            entry.update(replaced_ms=fwd["replaced_ms"],
                         bwd_replaced_ms=bwd["replaced_ms"],
                         row_walk_bound_ms=fwd["row_walk_bound_ms"],
                         bwd_row_walk_bound_ms=bwd["row_walk_bound_ms"])
            cases = {**k2_ood, "kg_eval": k2_kg,
                     "xe": (typed_errs[K2], typed_times[K2]),
                     "stray": loc_stray, "locsplit_local": loc_k2,
                     "halo_rem": k2_halo, **k2_ep}
            entry.update(case_fields(cases))
        line.append(entry)
    for entry in line:
        entry.update(case_fields({case: t for (name, case), t in
                                  mp_cases.items() if name == entry["name"]}))
    k3 = typed_times[K3]
    line.append({
        "name": K3, "route": "cuda",
        "source": f"stemgnn_tpu_torch/csrc/{K3}.cu",
        "replaces": "stemgnn_tpu/ops/scatter_pallas.py:480",
        "launches": paths["typed"][K3],
        "launches_by_path": {p: c[K3] for p, c in paths.items()},
        "max_abs_err": typed_errs[K3], "ms": k3["ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
        **case_fields({"path": k3_path, **{
            case: t for (name, case), t in mp_cases.items()
            if name == K3}})})
    print(json.dumps({"kernels": line}), flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def time_cases(name, cases):
    """The times of kernel ``name`` at each of ``cases`` (``{direction:
    (args, kw, extra)}``, :func:`time_case`), as one row of the kernels
    line."""
    return dict({direction: time_case(name, direction, *case)
                 for direction, case in cases.items()}, name=name)


def case_fields(cases):
    """The ``kernels`` line's fields of further launches of one kernel:
    {case: (max_abs_err, times)} as ``{case}_max_abs_err`` and
    ``{case}_{time}``."""
    out = {}
    for case, (err, t) in cases.items():
        out[f"{case}_max_abs_err"] = err
        out.update({f"{case}_{k}": v for k, v in t.items()})
    return out


def launch_case(tag, name, direction, call):
    """A recorded launch ``call`` (positional, keywords) of kernel ``name``
    run again: checked against its plain version at the tolerance of its
    out dtype, and timed (:func:`time_case`).  Returns (max_abs_err,
    times)."""
    a, kw = call
    kw = dict(kw)
    args = dict(zip(POSITIONAL[name], a))
    args.update({k: kw.pop(k) for k in POSITIONAL[name] if k in kw})
    extra = {"plan": kw.pop("plan")}
    fn, ref = KERNEL_FNS[name]
    x = args["m"] if name == K1 else args["x"]
    err = check_kernel(f"{tag} E_pad={args['local_row'].numel()} "
                       f"D={x.shape[1]}", fn(**args, **kw, **extra),
                       ref(**args, **kw), kw.get("out_dtype", torch.float32))
    return err, time_case(name, direction, args, kw, extra)


def time_case(name, direction, args, kw, extra):
    """Times of one real launch of kernel ``name`` (its arrays ``args`` by
    name, ``kw`` the keywords of the kernel and its plain version,
    ``extra`` the kernel's alone): the kernel, its plain version, its
    bound, a library yardstick and, for kernel 2, the bound with x read
    once per edge (the row walk) and the route it replaces (a gather +
    kernel 1 on the same tail)."""
    fn, ref = KERNEL_FNS[name]
    n_pad = kw["num_nodes_padded"]
    bp, lrow = args["block_ptr"], args["local_row"]
    x, table, xe = args.get("x"), args.get("table"), args.get("xe")
    # kernel 2's merged LocSplit: a stray edge reads stray_src[stray_idx[e]]
    src, sidx = kw.get("stray_src"), kw.get("stray_idx")
    relu = kw.get("relu", False)
    out_dtype = kw.get("out_dtype", torch.float32)
    dev = bp.device
    e_used = int(bp[-1])
    rows_out, live = sc._edge_rows(lrow.reshape(1, -1), bp)
    live = live[:e_used]
    rows_out = rows_out[:e_used][live]
    ms = cuda_ms(lambda: fn(**args, **kw, **extra), 20)
    plain = cuda_ms(lambda: ref(**args, **kw), 5)
    # each input read once, each output written once, each at its own
    # dtype's size: out, block_ptr, the epilogue's init, scale and gate,
    # then the edge stream (lrow, and m, keys, senders, types or stray
    # ranks) and the x rows (and stray rows) the launch reads
    d = (args["m"] if name == K1 else x).shape[1]
    nbytes = (n_pad * d * torch.finfo(out_dtype).bits // 8
              + bp.numel() * bp.element_size())
    nbytes += sum(t.numel() * t.element_size() for t in (
        kw.get("init"), kw.get("scale"), kw.get("gate")) if t is not None)
    flops = 2 * n_pad * d                               # the epilogue
    per_edge = lrow.element_size()
    if name == K1:
        per_edge += d * args["m"].element_size()
        flops += e_used * d * (2 if relu else 1)
    else:
        idx = (args["keys"] if name == K2 else args["senders"]).reshape(
            -1)[:e_used][live].long()
        # each edge's column of [x; stray_src]: its key, or N_pad + its
        # stray rank
        cols = idx
        if sidx is None:
            x_bytes = int(torch.unique(idx).numel()) * d * x.element_size()
        else:
            rank = sidx.reshape(-1)[:e_used][live].long()
            strays = rank >= 0
            cols = torch.where(strays, n_pad + rank, idx)
            x_bytes = (int(torch.unique(idx[~strays]).numel()) * d
                       * x.element_size()
                       + int(torch.unique(rank[strays]).numel()) * d
                       * src.element_size())
            per_edge += 4
        nbytes += x_bytes + (0 if table is None
                             else table.numel() * table.element_size())
        per_edge += 4 + (0 if xe is None else 4)
        if name == K2:
            flops += e_used * d * ((2 if relu else 1) + (table is not None))
        else:
            per_edge += d * args["m"].element_size()
            flops += 3 * e_used * d
    nbytes += e_used * per_edge
    b_ms, b_by = bound_ms(nbytes, flops)
    out = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
    # yardstick: one PyTorch call computing the same sums
    if name == K2 and xe is None:
        # A @ f(x) for the tail's count matrix A (f = relu(x + t0) rounded
        # to bf16, or x itself; x with the stray rows below it): one
        # sparse product in the out dtype
        f = x if src is None else torch.cat([x, src.to(x.dtype)])
        f = f.float() + (0.0 if table is None else table.float())
        f = (torch.relu(f) if relu else f).to(torch.bfloat16).to(out_dtype)
        a = torch.sparse_coo_tensor(
            torch.stack([rows_out, cols]),
            torch.ones(rows_out.numel(), device=dev, dtype=out_dtype),
            (n_pad, f.shape[0]),
            check_invariants=False).coalesce().to_sparse_csr()
        out["library_ms"] = cuda_ms(lambda: torch.sparse.mm(a, f), 20)
        lib = f"torch.sparse.mm (CSR {str(out_dtype)[6:]})"
        del a, f
    else:
        if name == K1:
            msg = args["m"][:e_used][live].float()
            msg = torch.relu(msg) if relu else msg
            lib = "index_add_ of the f32 messages"
        else:
            pre = x.index_select(0, idx).float()
            if table is not None:
                pre = pre + (table.float() if xe is None else
                             table.index_select(0, xe.reshape(-1)[:e_used][
                                 live].long()).float())
            if name == K2:
                msg = (torch.relu(pre) if relu else pre).to(
                    torch.bfloat16).float()
                lib = "index_add_ of the pre-built f32 messages"
            else:
                msg = torch.where(pre > 0, args["m"][:e_used][live].float(),
                                  0.0)
                lib = "index_add_ of the pre-masked f32 gradients"
            del pre
        out["library_ms"] = cuda_ms(lambda: torch.zeros(
            n_pad, d, device=dev).index_add_(0, rows_out, msg), 20)
        del msg
    if name == K2:
        plan, keys = extra["plan"], args["keys"].reshape(-1)
        valid = (lrow.reshape(-1) < sc.NODE_BLOCK)[:, None]
        k1_kw = {k: v for k, v in kw.items() if not k.startswith("stray_")}

        def replaced():
            m = x.index_select(0, keys.clamp(max=n_pad - 1).long())
            if sidx is not None:
                r = sidx.reshape(-1).long()
                m = torch.where((r >= 0)[:, None], src.to(m.dtype)
                                .index_select(0, r.clamp(min=0)), m)
            if table is not None:
                m = m + (table if xe is None
                         else table.index_select(0, xe.reshape(-1).long()))
            m = torch.where(valid, m, torch.zeros((), dtype=m.dtype,
                                                  device=dev))
            return sc.scatter_rows_sorted(m, lrow, bp, plan=plan, **k1_kw)
        out["replaced_ms"] = cuda_ms(replaced, 20)
        out["row_walk_bound_ms"] = bound_ms(
            nbytes - x_bytes + e_used * d * x.element_size(), flops)[0]
    shown = "".join(f", {k} {v:.3f} ms" for k, v in out.items()
                    if k.endswith("_ms") and k not in ("plain_ms",
                                                       "bound_ms"))
    print(f"  {name} {direction} at E={e_used} D={d} N_pad={n_pad}, "
          f"{str(out_dtype)[6:]} out: kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms, bound {b_ms:.3f} ms ({b_by}, "
          f"{nbytes / 1e9:.3f} GB at 3.35 TB/s){shown} (library = {lib})",
          flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
