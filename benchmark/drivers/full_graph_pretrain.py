"""Driver of the full-graph pretrain step: ``train.pretrain_loop.
make_pretrain_step(cfg, bs=N_pad)`` over ``pretrain_graph``, one step a
unit, with draws the benchmark makes and hands to the step.

Set-up builds the graph and its layout, the model from seeded weights, its
EMA teacher and AdamW, then drives the first ``checked_steps`` steps
through the same call the window makes, keeping what the comparison reads:
each step's loss, the first step's gradient (from AdamW's first moment),
every leaf after the last checked step, and each step's draws and
dropout-generator state, which the reference is handed too."""

from __future__ import annotations

import time

import torch

from benchmark import common
from benchmark.drivers import _shared

UNIT = "step"


class Cell:
    def __init__(self, cell: dict, seed: int, device):
        self.conf, self.traffic = cell["conf"], cell["traffic_mix"]
        self.seed, self.device = seed, torch.device(device)
        self.losses = []

    # -- set-up ------------------------------------------------------------
    def setup(self):
        t_imports = time.perf_counter()
        from stemgnn_tpu_torch.core.config import FinetuneConfig, \
            PretrainConfig, from_dict
        from stemgnn_tpu_torch.models.pretrain import (PretrainModel,
                                                       make_teacher)
        from stemgnn_tpu_torch.train.graph_setup import fused_full_graph
        from stemgnn_tpu_torch.train.pretrain_loop import (
            make_pretrain_optimizer, make_pretrain_step, pretrain_graph)

        t_imports = time.perf_counter() - t_imports
        cfg = from_dict(PretrainConfig(), self.conf)
        self.cfg, dev = cfg, self.device

        def build(ds):
            if dev.type == "cuda":
                return ds, pretrain_graph(ds, cfg, dev)
            # the layout path on the CPU (the kernels' plain versions), as
            # pretrain_graph builds it on the card
            return ds, fused_full_graph(ds, FinetuneConfig(
                encoder=cfg.encoder), device=dev, use_layout=True,
                edge_feat=True)
        _, self.graph, self.host = _shared.program_graph(
            self.traffic, self.seed, cfg.encoder.input_dim, dev, build)
        self.bs = self.graph.num_nodes_padded
        if self.conf["batch_size"] != self.bs:
            raise ValueError(f"the configuration states "
                             f"{self.conf['batch_size']} rows a step, the "
                             f"graph has {self.bs}")
        t_model = time.perf_counter()
        self.model = PretrainModel(cfg).to(dev)
        named = dict(self.model.named_parameters())
        _shared.write_weights(named, self.seed + 1, dev)
        self.teacher = make_teacher(self.model)
        t_opt = time.perf_counter()
        self.opt = make_pretrain_optimizer(self.model, cfg)
        t_opt = time.perf_counter() - t_opt
        self.gen = torch.Generator(device=dev).manual_seed(self.seed + 2)
        self.draw_gen = torch.Generator(device=dev).manual_seed(
            self.seed + 3)
        self.step_fn = make_pretrain_step(cfg, self.bs, generator=self.gen)
        t0 = time.perf_counter()
        self.host["stages"].update(program_imports_s=t_imports,
                                   model_s=t0 - t_model,
                                   optimizer_s=t_opt)
        self.init = self._leaves()
        self.checked = []
        for t in range(int(self.traffic["checked_steps"])):
            draws = self.draw()
            state = self.gen.get_state()
            out = self.step_fn(self.model, self.teacher, self.opt,
                               self.graph, draws)
            self.checked.append(dict(draws=draws, rng_state=state,
                                     loss=float(out["loss"]),
                                     parts={k: float(v) for k, v in
                                            out.items()}))
            if t == 0:
                self.grads1 = _shared.adam_first_grads(self.opt.opt, named)
        self.after = self._leaves()
        self.host["stages"]["checked_s"] = time.perf_counter() - t0

    def _leaves(self) -> dict:
        out = _shared.snapshot(dict(self.model.named_parameters()))
        out.update({"teacher." + k: v for k, v in _shared.snapshot(
            dict(self.teacher.named_parameters())).items()})
        return out

    def draw(self) -> dict:
        """One step's draws, as the program's ``draw_step`` forms them."""
        cfg, g, gen, dev = self.cfg, self.graph, self.draw_gen, self.device
        e_pad = g.num_edges_padded
        num = max(int(e_pad * cfg.topo_recon_ratio), 1)
        n = max(g.n_node, 1)
        return dict(
            feat_keep=torch.rand(g.node_feat.shape[1], generator=gen,
                                 device=dev) < 1.0 - cfg.feat_p,
            drop_seed=torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                                    device=dev),
            slots=torch.randint(0, e_pad, (num,), generator=gen, device=dev),
            neg=(torch.randint(0, n, (num,), generator=gen, device=dev),
                 torch.randint(0, n, (num,), generator=gen, device=dev)),
            ortho_ids=torch.randperm(cfg.vq.codebook_size, generator=gen,
                                     device=dev)[
                :cfg.vq.orthogonal_reg_max_codes])

    # -- the measured unit -------------------------------------------------
    def step(self):
        out = self.step_fn(self.model, self.teacher, self.opt, self.graph,
                           self.draw())
        self.losses.append(out["loss"])

    def failed(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    # -- per-layer work ----------------------------------------------------
    def aggregation_call(self):
        return _shared.aggregation_call(self.graph, self.cfg.encoder,
                                        self.seed + 4, self.cfg.edge_p)

    def aggregation_work(self) -> dict:
        from benchmark.work import aggregation
        return aggregation.sage_mean(self.host["senders"], self.host["n"],
                                     self.cfg.encoder.input_dim,
                                     dropout=True)

    def model_flops(self) -> float:
        """Model FLOPs of one step (``work.model_flops``)."""
        from benchmark.work import model_flops
        return model_flops.pretrain_step(
            self.conf, self.host["n"], self.host["senders"].shape[0],
            max(int(self.graph.num_edges_padded
                    * self.cfg.topo_recon_ratio), 1))

    # -- the comparison ----------------------------------------------------
    def release(self):
        self.data = _shared.reference_data(self.host, self.graph,
                                           self.device)
        for name in ("model", "teacher", "opt", "step_fn", "graph"):
            setattr(self, name, None)
        common.free_cuda()

    def reference(self, ref, **kw):
        return ref.run(self.conf, self.data, self.init,
                       [dict(draws=c["draws"], rng_state=c["rng_state"])
                        for c in self.checked], **kw)

    def readings(self, ref_out: dict, prog=None) -> dict:
        """The numbers compared: the program's (or ``prog``'s, another
        run of the reference put in its place) against ``ref_out``."""
        from benchmark import compare
        if prog is None:
            prog = dict(losses=[c["loss"] for c in self.checked],
                        parts=[c["parts"] for c in self.checked],
                        grads1=self.grads1, params=self.after)
        moved = compare.moved_leaves(ref_out["grads1"])
        moved += ["teacher." + k[len("encoder."):] for k in moved
                  if k.startswith("encoder.")]
        out = _shared.training_readings(self.init, prog, ref_out, moved)
        # the first step's terms: the step starts from the same state on
        # both sides, so no earlier rounding reaches them
        out.update(compare.part_gaps(prog["parts"][0], ref_out["parts"][0]))
        return out
