"""The minibatch pretrain unit (``train.pretrain_loop.MinibatchPretrain``)
against ``run_pretrain``, which calls it a batch, and the sampler's batch
counter (``data.sampler.batch_counts``) on hand-checked graphs.  Torch
only, on the CPU."""

import copy

import numpy as np
import pytest
import torch

from stemgnn_tpu_torch.core.config import (EncoderConfig, PretrainConfig,
                                           VQConfig)
from stemgnn_tpu_torch.data import sampler
from stemgnn_tpu_torch.data.merge import merge_datasets
from stemgnn_tpu_torch.data.synthetic import synthetic_node_dataset
from stemgnn_tpu_torch.models.pretrain import PretrainModel, make_teacher
from stemgnn_tpu_torch.train import pretrain_loop

D, BS, STEPS = 16, 64, 6


def _cfg():
    return PretrainConfig(
        encoder=EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                              normalize="batch", dropout=0.1),
        vq=VQConfig(dim=D, codebook_size=8, codebook_dim=D, heads=2,
                    orthogonal_reg_max_codes=4),
        batch_size=BS, fanout=5, epochs=3)


def _merged():
    return merge_datasets([synthetic_node_dataset(
        num_nodes=300, num_classes=5, feat_dim=D, avg_degree=6,
        pref_attach=1.1, num_splits=1, seed=3)])


def _csc(merged):
    return sampler.CSCGraph.from_edge_index(merged["edge_index"],
                                            merged["x"].shape[0])


class _Draws:
    """A ``draw_fn`` drawing with the program's ``draw_step`` from its own
    generator, keeping each graph and its draws."""

    def __init__(self, cfg):
        self.cfg, self.gen = cfg, torch.Generator().manual_seed(11)
        self.seen = []

    def __call__(self, graph):
        draws = pretrain_loop.draw_step(self.cfg, graph, self.gen)
        self.seen.append((graph, draws))
        return draws


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], (tuple, list)):
            assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k
        elif a[k] is not None:
            assert torch.equal(a[k], b[k]), k


def test_unit_steps_as_run_pretrain():
    """``STEPS`` calls of the unit with ``roll_over`` (4 batches of 64 an
    epoch of 300 seeds, so the fifth call starts the second epoch and draws
    its seeds again) give ``run_pretrain(max_steps=STEPS)``'s batches,
    draws, step losses, padded-row shares and final weights, bit for
    bit."""
    cfg, merged = _cfg(), _merged()
    model0 = PretrainModel(cfg, generator=torch.Generator().manual_seed(5))
    teacher0 = make_teacher(model0)

    draws_a = _Draws(cfg)
    model_a, teacher_a, hist = pretrain_loop.run_pretrain(
        merged, cfg, weights=[1.0], max_steps=STEPS, verbose=False,
        device="cpu", model=copy.deepcopy(model0),
        teacher=copy.deepcopy(teacher0), draw_fn=draws_a)

    model_b, teacher_b = copy.deepcopy(model0), copy.deepcopy(teacher0)
    opt = pretrain_loop.make_pretrain_optimizer(model_b, cfg)
    node_table, edge_table = pretrain_loop._tables(merged, "cpu")
    draws_b = _Draws(cfg)
    unit = pretrain_loop.MinibatchPretrain(
        merged, cfg, pretrain_loop.make_pretrain_step(
            cfg, cfg.batch_size, generator=torch.Generator().manual_seed(
                cfg.seed)),
        node_table, edge_table, weights=[1.0],
        rng=np.random.default_rng(cfg.seed), csc=_csc(merged), device="cpu",
        draw_fn=draws_b)
    losses, batches = [], []
    for _ in range(STEPS):
        out = unit(model_b, teacher_b, opt, roll_over=True)
        losses.append(float(out["loss"]))
        batches.append(unit.batch)
        assert unit.batch["seeds"] == BS
        assert unit.batch["draws"] is draws_b.seen[-1][1]

    assert [len(h["step_losses"]) for h in hist] == [4, STEPS - 4]
    assert losses == [v for h in hist for v in h["step_losses"]]
    assert len(draws_a.seen) == len(draws_b.seen) == STEPS
    for (ga, da), (gb, db), b in zip(draws_a.seen, draws_b.seen, batches):
        for name in ("node_feat", "senders", "receivers", "node_mask",
                     "edge_mask", "edge_feat"):
            assert torch.equal(getattr(ga, name), getattr(gb, name)), name
        assert torch.equal(gb.node_feat[:b["ig"].n_node],
                           node_table[torch.from_numpy(
                               b["ig"].node_ids[:b["ig"].n_node]).long()])
        _equal_trees(da, db)
    for a, b in ((model_a, model_b), (teacher_a, teacher_b)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for h, part in zip(hist, (batches[:4], batches[4:])):
        igs = [b["ig"] for b in part]
        rows = sum(ig.num_nodes_padded for ig in igs)
        want = (rows - sum(ig.n_node for ig in igs)) / rows
        assert h["batch/pad_share"] == pytest.approx(want, abs=1e-12)


def test_unit_without_an_epoch_returns_none():
    """Without ``roll_over`` a call at the end of an epoch (or before the
    first) returns None and steps nothing."""
    cfg, merged = _cfg(), _merged()
    model = PretrainModel(cfg)
    opt = pretrain_loop.make_pretrain_optimizer(model, cfg)
    node_table, edge_table = pretrain_loop._tables(merged, "cpu")
    unit = pretrain_loop.MinibatchPretrain(
        merged, cfg, pretrain_loop.make_pretrain_step(cfg, BS), node_table,
        edge_table, weights=[0.5], rng=np.random.default_rng(0),
        csc=_csc(merged), device="cpu")
    teacher = make_teacher(model)
    assert unit(model, teacher, opt) is None
    unit.new_epoch()
    assert unit(model, teacher, opt) is not None       # 150 seeds: 2
    assert unit(model, teacher, opt) is not None
    assert unit(model, teacher, opt) is None
    assert unit(model, teacher, opt, roll_over=True) is not None


def _star_chain():
    """Nodes 1-5 point at node 0, node 6 at node 1: 7 nodes, 6 edges."""
    ei = np.array([[1, 2, 3, 4, 5, 6], [0, 0, 0, 0, 0, 1]])
    return sampler.CSCGraph.from_edge_index(ei, 7)


def _one_batch(csc, fanouts, native, **pads):
    before = dict(sampler.batch_counts)
    it = sampler.NeighborBatchIterator(
        csc, np.arange(csc.num_nodes), None, np.array([0]), 1, fanouts,
        np.random.default_rng(0), use_native=native, shuffle=False, **pads)
    ig = next(iter(it))[0]
    delta = {k: sampler.batch_counts[k] - before.get(k, 0)
             for k in sampler.batch_counts}
    return ig, delta, before


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_batch_counts_by_hand(native):
    """Seed 0 of the star-and-chain graph at fanout 10 takes every in-edge:
    hop 1 the five edges from nodes 1-5, hop 2 the edge from node 6, so 7
    nodes and 6 edges, in buckets of 16 rows and 128 slots: 9 of the 16
    rows hold no node."""
    ig, delta, before = _one_batch(_star_chain(), [10, 10], native,
                                   node_pad=16, edge_pad=128)
    assert (ig.n_node, ig.n_edge) == (7, 6)
    assert delta == dict(batches=1, nodes=7, node_rows=16, edges=6,
                         edge_slots=128, truncations=0, escalations=0)
    assert sampler.padded_row_share(before) == pytest.approx(9 / 16)


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_batch_counts_an_escalation(native):
    """A bucket of 4 rows is too small for the 7 nodes: it grows to 128
    (7 + 7 // 8 + 1 rounded up to 128), no edge dropped."""
    ig, delta, _ = _one_batch(_star_chain(), [10, 10], native, node_pad=4,
                              edge_pad=128)
    assert delta == dict(batches=1, nodes=7, node_rows=128, edges=6,
                         edge_slots=128, truncations=0, escalations=1)
    assert ig.num_nodes_padded == 128


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_batch_counts_a_truncation(native):
    """200 nodes point at node 0; an unbounded hop from one seed meets the
    closure caps of 128 nodes and 128 edges: the seed and 127 senders are
    kept with their 127 edges, and the batch counts as truncated."""
    ei = np.stack([np.arange(1, 201), np.zeros(200, np.int64)])
    csc = sampler.CSCGraph.from_edge_index(ei, 201)
    ig, delta, _ = _one_batch(csc, [-1], native)
    assert (ig.n_node, ig.n_edge) == (128, 127)
    assert delta["truncations"] == 1 and delta["escalations"] == 0
    assert (delta["nodes"], delta["edges"]) == (128, 127)
    assert (delta["node_rows"], delta["edge_slots"]) == (
        ig.num_nodes_padded, ig.num_edges_padded)


def test_padded_row_share_with_nothing_built():
    assert sampler.padded_row_share(dict(sampler.batch_counts)) == 0.0
