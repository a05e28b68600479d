"""Driver of the minibatch pretrain step: ``train.pretrain_loop.
MinibatchPretrain``, the unit of ``run_pretrain``'s epoch (the next seed
batch sampled on the host, its ids copied and its features gathered on the
card, one optimizer step), one call a unit, rolling over into the next
epoch (its seeds drawn again) where an epoch runs out.

Set-up builds the graph (from the traffic's ``graph_seed``: one graph, as
the reference trains on one dataset, so the sampler's padding buckets, which
it probes from the graph, and every step's shapes are the same in every
run), the merged payload's ids, the CSC graph and the resident feature
tables (made on the card from the run's seed), the model from seeded weights,
its EMA teacher and AdamW, then drives the first ``checked_steps`` units
through the same call the window makes, keeping what the comparison reads:
each step's loss and terms, the first step's gradient (from AdamW's first
moment) and student encoding (``z``, by a forward hook on the student's
encoder, removed before the window), every leaf after the last checked
step, and each step's batch (padded ids, validity, seed count), draws and
dropout-generator state, which the reference is handed too.  The draws
come from the program's own ``draw_step`` on a generator of the
benchmark's, handed to the unit as its ``draw_fn``; as both sides take the
same batches and draws, the reference's ``batch_faults`` checks them
against the graph (``graphgen``'s edges) in plain numpy."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import common, graphgen
from benchmark.drivers import _shared
from benchmark.drivers.full_graph_pretrain import Cell as FullGraphCell
# the unit this cell measures; a program without it cannot run the cell
from stemgnn_tpu_torch.train.pretrain_loop import MinibatchPretrain

UNIT = "step"


class Cell(FullGraphCell):
    """The full-graph cell's comparison (``readings``, ``failed``), over
    minibatch steps."""

    # -- set-up ------------------------------------------------------------
    def setup(self):
        t_imports = time.perf_counter()
        from stemgnn_tpu_torch.core.config import PretrainConfig, from_dict
        from stemgnn_tpu_torch.data.sampler import CSCGraph
        from stemgnn_tpu_torch.models.pretrain import (PretrainModel,
                                                       make_teacher)
        from stemgnn_tpu_torch.train.pretrain_loop import (
            batch_layouts_on, draw_step, make_pretrain_optimizer,
            make_pretrain_step)

        t_imports = time.perf_counter() - t_imports
        traffic, dev = self.traffic, self.device
        cfg = from_dict(PretrainConfig(), dict(
            self.conf, fused_minibatch=traffic["fused_minibatch"]))
        self.cfg = cfg
        fanouts = [cfg.fanout] * cfg.encoder.num_layers
        if (cfg.batch_size, fanouts) != (traffic["batch_size"],
                                         traffic["fanouts"]):
            raise ValueError(f"the configuration states batches of "
                             f"{cfg.batch_size} seeds and fanouts {fanouts}, "
                             f"the traffic {traffic['batch_size']} and "
                             f"{traffic['fanouts']}")
        params = traffic["graph"]
        t0 = time.perf_counter()
        s = graphgen.structure(params, int(traffic["graph_seed"]))
        n, e = int(params["num_nodes"]), s["senders"].shape[0]
        edge_index = np.stack([s["senders"], s["receivers"]])
        # the merged payload of one dataset: node i reads row i of the
        # node table, every edge the one edge-text row
        merged = dict(x=np.arange(n), xe=np.zeros(e, np.int64),
                      edge_index=edge_index, ptr=np.asarray([0, n]),
                      names=["arxiv_like"])
        csc = CSCGraph.from_edge_index(edge_index, n)
        t_structure = time.perf_counter() - t0
        self.structure = dict(edge_index=edge_index, num_nodes=n)
        self.batch_check = None
        self.table, self.t0 = graphgen.device_features(
            params, s["labels"], cfg.encoder.input_dim, self.seed, dev)
        self.n = n
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
        self.unit = MinibatchPretrain(
            merged, cfg, make_pretrain_step(cfg, cfg.batch_size,
                                            generator=self.gen),
            self.table, self.t0, weights=traffic["seed_weights"],
            rng=np.random.default_rng(self.seed + 4), csc=csc, device=dev,
            with_layout=batch_layouts_on(cfg),
            draw_fn=lambda g: draw_step(cfg, g, self.draw_gen))
        t1 = time.perf_counter()
        self.host = dict(stages=dict(program_imports_s=t_imports,
                                     structure_s=t_structure,
                                     model_s=t1 - t_model,
                                     optimizer_s=t_opt))
        self.init = self._leaves()
        self.checked = []
        kept = []
        hook = self.model.encoder.register_forward_hook(
            lambda mod, args, out: kept.append(out[0].detach().clone())
            if not kept else None)
        for t in range(int(traffic["checked_steps"])):
            state = self.gen.get_state()
            out = self.unit(self.model, self.teacher, self.opt,
                            roll_over=True)
            b = self.unit.batch
            ig = b["ig"]
            self.checked.append(dict(
                draws=b["draws"], rng_state=state, seeds=int(b["seeds"]),
                node_ids=ig.node_ids, senders=ig.senders,
                receivers=ig.receivers, node_mask=ig.node_mask,
                edge_mask=ig.edge_mask, loss=float(out["loss"]),
                parts={k: float(v) for k, v in out.items()}))
            if t == 0:
                self.grads1 = _shared.adam_first_grads(self.opt.opt, named)
        hook.remove()
        self.z1 = kept[0]
        self.after = self._leaves()
        self.host["stages"]["checked_s"] = time.perf_counter() - t1

    # -- the measured unit -------------------------------------------------
    def step(self):
        out = self.unit(self.model, self.teacher, self.opt, roll_over=True)
        self.losses.append(out["loss"])

    # -- per-layer work ----------------------------------------------------
    def aggregation_call(self):
        """Layer 1's aggregation of the last batch through the public front
        end the SAGE layers call (``ops.spmm.sage_aggregate``) on the
        cell's route (no layout: the edge features materialized, the
        pair-hash dropout folded into the edge mask), forward and
        backward."""
        from stemgnn_tpu_torch.ops.spmm import sage_aggregate
        g = self.unit.batch["graph"]
        x = g.node_feat.detach().clone().requires_grad_(True)
        gen = torch.Generator(device=x.device).manual_seed(self.seed + 5)
        up = torch.randn(x.shape, device=x.device, generator=gen)
        drop = (torch.tensor(self.seed % (2 ** 31 - 1), device=x.device),
                self.cfg.edge_p)

        def run():
            out = sage_aggregate(x, g.senders, g.receivers,
                                 edge_feat=g.edge_feat, edge_mask=g.edge_mask,
                                 num_nodes=x.shape[0], drop_hash=drop)
            out.backward(up)
        return run

    def aggregation_work(self) -> dict:
        from benchmark.work import aggregation
        ig = self.unit.batch["ig"]
        return aggregation.sage_mean(ig.senders[:ig.n_edge], ig.n_node,
                                     self.cfg.encoder.input_dim,
                                     dropout=True,
                                     receivers=ig.receivers[:ig.n_edge])

    def model_flops(self) -> float:
        """Model FLOPs of one step (``work.model_flops``) at the real
        (unpadded) nodes and edges of the average batch built
        (``data.sampler.batch_counts``), the topo-recon slots of the
        average padded edge count; the feature decoder reads the seed
        rows alone."""
        from stemgnn_tpu_torch.data.sampler import batch_counts
        from benchmark.work import model_flops
        c, conf = batch_counts, self.conf
        batches = max(c["batches"], 1)
        n, e = c["nodes"] / batches, c["edges"] / batches
        slots = max(int(c["edge_slots"] / batches
                        * self.cfg.topo_recon_ratio), 1)
        dim, d_in = conf["encoder"]["hidden_dim"], conf["encoder"][
            "input_dim"]
        seeds = min(conf["batch_size"], n)
        return (model_flops.pretrain_step(conf, n, e, slots)
                - 3 * (model_flops.mm(n, dim, d_in)
                       - model_flops.mm(seeds, dim, d_in)))

    # -- the comparison ----------------------------------------------------
    def release(self):
        self.data = dict(table=self.table, t0=self.t0)
        for name in ("model", "teacher", "opt", "unit"):
            setattr(self, name, None)
        common.free_cuda()

    def readings(self, ref_out: dict, prog=None) -> dict:
        """The full-graph cell's numbers; ``z_gap``: the first step's
        student encoding against the reference's over the batch's nodes,
        ``||z_prog - z_ref|| / ||z_ref||``, read before the VQ, so a code
        flipped at a near-tie does not reach it, while a dense product
        rounded to TF32 does; and ``batch_faults``: the rules of sampling
        and drawing that the checked batches break (the reference's
        ``batch_faults``), which the comparison of the steps cannot see,
        as both sides take the same batches."""
        out = super().readings(ref_out, prog)
        out["batch_faults"] = float(self.batch_check)
        z = self.z1 if prog is None else prog["z1"]
        rows = torch.as_tensor(self.checked[0]["node_mask"]).to(z.device)
        dz = (z[rows].double() - ref_out["z1"][rows].double()).norm()
        out["z_gap"] = float(dz / ref_out["z1"][rows].double().norm())
        return out

    def reference(self, ref, **kw):
        steps = [{k: c[k] for k in (
            "draws", "rng_state", "seeds", "node_ids", "senders",
            "receivers", "node_mask", "edge_mask")} for c in self.checked]
        if self.batch_check is None:
            self.batch_check = ref.batch_faults(self.structure, self.conf,
                                                steps)
        return ref.run(self.conf, self.data, self.init, steps, **kw)
