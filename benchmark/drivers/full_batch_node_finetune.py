"""Driver of the full-batch node finetune: one epoch a unit, as
``train.finetune_loop.run_finetune`` runs it: ``_make_node_steps(cfg,
"node")``'s ``train_step`` over the whole graph, its ``eval_step`` over the
whole graph, the probabilities read back, and the train / valid / test
accuracies scored on the host (``utils.metrics.evaluate``).  Early stopping
never ends the window.

Set-up does what ``run_finetune`` does before its first epoch (the
locality relabel check, the fused full graph, the task model, AdamW over
the unfrozen leaves), with seeded weights and a frozen VQ handed over
initialised, then runs the first ``checked_steps`` epochs through the
window's own call, keeping each step's loss, the first step's gradient,
every trained leaf after the last checked epoch, that epoch's
probabilities and each step's dropout-generator state."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import common
from benchmark.drivers import _shared

UNIT = "epoch"


class Cell:
    def __init__(self, cell: dict, seed: int, device):
        self.conf, self.traffic = cell["conf"], cell["traffic_mix"]
        self.seed, self.device = seed, torch.device(device)
        self.losses, self.scores = [], []
        self.eval_events = None

    def setup(self):
        t_imports = time.perf_counter()
        from stemgnn_tpu_torch.core.config import FinetuneConfig, from_dict
        from stemgnn_tpu_torch.models.task import task_model_init
        from stemgnn_tpu_torch.nn.encoder import Encoder
        from stemgnn_tpu_torch.train.finetune_loop import (
            _make_node_steps, _split_params, make_optimizer)
        from stemgnn_tpu_torch.train.graph_setup import (
            fused_full_graph, maybe_reorder_dataset)
        from stemgnn_tpu_torch.utils.metrics import evaluate
        from stemgnn_tpu_torch.vq.quantize import VectorQuantize

        t_imports = time.perf_counter() - t_imports
        cfg = from_dict(FinetuneConfig(), self.conf)
        self.cfg, dev = cfg, self.device
        self.evaluate = evaluate

        def build(ds):
            ds = maybe_reorder_dataset(ds, cfg, "node", dev)
            return ds, fused_full_graph(
                ds, cfg, device=dev,
                use_layout=True if dev.type != "cuda" else None)
        ds, self.graph, self.host = _shared.program_graph(
            self.traffic, self.seed, cfg.encoder.input_dim, dev, build)
        n, n_pad = self.host["n"], self.graph.num_nodes_padded
        y = np.zeros(n_pad, np.int64)
        y[:n] = self.host["labels"]
        self.y_np, self.y = y, torch.from_numpy(y).to(dev)
        self.masks = {}
        for k in ("train", "valid", "test"):
            m = np.zeros(n_pad, bool)
            m[:n] = self.host["splits"][k]
            self.masks[k] = m
        self.train_mask = torch.from_numpy(self.masks["train"]).to(dev)

        t_model = time.perf_counter()
        vq = VectorQuantize(cfg.vq)
        self.model = task_model_init(cfg, Encoder(cfg.encoder), vq).to(dev)
        named = dict(self.model.named_parameters())
        _shared.write_weights(named, self.seed + 1, dev)
        # a pretrained VQ arrives initialised: no k-means at set-up
        self.model.vq.initted.fill_(True)
        trainable, _ = _split_params(self.model, cfg)
        t_opt = time.perf_counter()
        self.opt = make_optimizer(trainable, cfg)
        t_opt = time.perf_counter() - t_opt
        _, self.train_step, self.eval_step = _make_node_steps(cfg, "node")
        self.gen = torch.Generator(device=dev).manual_seed(self.seed + 2)
        t0 = time.perf_counter()
        self.host["stages"].update(program_imports_s=t_imports,
                                   model_s=t0 - t_model,
                                   optimizer_s=t_opt)
        self.init = _shared.snapshot(named)
        self.checked = []
        for t in range(int(self.traffic["checked_steps"])):
            state = self.gen.get_state()
            loss, pred = self.epoch()
            self.checked.append(dict(rng_state=state, loss=float(loss)))
            if t == 0:
                self.grads1 = _shared.adam_first_grads(self.opt, trainable)
        self.pred = pred
        self.after = _shared.snapshot(trainable)
        self.host["stages"]["checked_s"] = time.perf_counter() - t0
        self.losses, self.scores = [], []

    def epoch(self):
        """One epoch as ``run_finetune`` runs it: ``(loss, probabilities)``,
        the loss a device scalar, the probabilities on the host."""
        losses = self.train_step(self.model, self.opt, self.train_mask,
                                 self.graph, self.y, self.gen)
        if self.eval_events is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        pred = self.eval_step(self.model, self.graph)
        if self.eval_events is not None:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            self.eval_events.append((start, stop))
        pred = np.asarray(pred.cpu())
        self.scores.append(tuple(
            self.evaluate(pred, self.y_np, self.masks[k], "node")
            for k in ("train", "valid", "test")))
        return losses["loss"], pred

    def step(self):
        self.losses.append(self.epoch()[0])

    def failed(self) -> int:
        if not self.losses:
            return 0
        bad = int((~torch.isfinite(torch.stack(self.losses))).sum())
        return bad + sum(not np.all(np.isfinite(s)) for s in self.scores)

    def time_evaluations(self):
        """Record CUDA events around each evaluation from now on."""
        self.eval_events = []

    def eval_ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.eval_events or []]

    def aggregation_call(self):
        return _shared.aggregation_call(self.graph, self.cfg.encoder,
                                        self.seed + 4)

    def aggregation_work(self) -> dict:
        from benchmark.work import aggregation
        return aggregation.sage_mean(self.host["senders"], self.host["n"],
                                     self.cfg.encoder.input_dim,
                                     dropout=False)

    def model_flops(self) -> float:
        """Model FLOPs of one epoch (``work.model_flops``)."""
        from benchmark.work import model_flops
        return model_flops.finetune_epoch(self.conf, self.host["n"],
                                          self.host["senders"].shape[0])

    def release(self):
        self.data = _shared.reference_data(self.host, self.graph,
                                           self.device)
        for name in ("model", "opt", "graph", "train_step", "eval_step"):
            setattr(self, name, None)
        common.free_cuda()

    def reference(self, ref, **kw):
        return ref.run(self.conf, self.data, self.init,
                       [dict(rng_state=c["rng_state"])
                        for c in self.checked], **kw)

    def readings(self, ref_out: dict, prog=None, min_margin: float = 0.0):
        from benchmark import compare
        if prog is None:
            prog = dict(losses=[c["loss"] for c in self.checked],
                        grads1=self.grads1, params=self.after,
                        probs=self.pred)
        moved = compare.moved_leaves(ref_out["grads1"])
        out = _shared.training_readings(self.init, prog, ref_out, moved)
        rows = self.data["node_mask"] & (ref_out["margin"] >= min_margin)
        out["prob_gap"] = compare.prob_gap(prog["probs"], ref_out["probs"],
                                           rows)
        out["_leaves"].update(rows=int(rows.sum()),
                              valid=int(self.data["node_mask"].sum()))
        return out
