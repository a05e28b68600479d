"""The minibatch pretrain cell (``pretrain.mb.arxiv``) on the CPU at a tiny
size: a sound run reads ``correct`` true far under every limit, each fault
reads it false, the model FLOPs of a batch match a count made by hand, and
the cell's readers find nothing in an empty context."""

import collections

import numpy as np
import pytest

from benchmark import common, run
from benchmark.tests.conftest import tiny_cell

CELL = "pretrain.mb.arxiv"
READERS = ("sample_ms.mb", "transfer_ms.mb", "batch_idle_ms.mb",
           "pad_share.mb", "idle_share.mb", "mfu.mb", "agg_roofline.mb")


def tiny_mb_cell(n: int = 600, batch_size: int = 64) -> dict:
    """``tiny_cell``'s widths and a graph of ``n`` nodes, with batches of
    ``batch_size`` seeds (the configuration's and the traffic's): an epoch
    of ``5 n`` seeds, the fanouts as published."""
    w = tiny_cell(CELL, n)
    w["conf"]["batch_size"] = batch_size
    w["traffic_mix"]["batch_size"] = batch_size
    return w


def _run():
    return run.run_cell(tiny_mb_cell(), 3 * 2 ** 31 + 7, 0.3, False,
                        device="cpu")


def test_sound_run_is_correct_far_under_its_limits():
    res = _run()
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"step_ms", "peak_mem_gb", "setup_s"}
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"] / 10, name


def test_step_leaves_its_state_unchanged(monkeypatch):
    from stemgnn_tpu_torch.train import optim
    monkeypatch.setattr(optim.Optimizer, "step", lambda self: None)
    res = _run()
    assert res["correct"] is False
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_step_leaves_half_the_batch_out(monkeypatch):
    import dataclasses

    import torch

    from stemgnn_tpu_torch.train import pretrain_loop
    inner = pretrain_loop.pretrain_forward

    def every_other(mask):
        return mask & (torch.arange(mask.shape[0]) % 2 == 0)

    def half(model, teacher, cfg, aug_g, orig_g, **kw):
        aug_g = dataclasses.replace(aug_g,
                                    node_mask=every_other(aug_g.node_mask))
        orig_g = dataclasses.replace(orig_g,
                                     node_mask=every_other(orig_g.node_mask))
        return inner(model, teacher, cfg, aug_g, orig_g, **kw)
    monkeypatch.setattr(pretrain_loop, "pretrain_forward", half)
    res = _run()
    assert res["correct"] is False
    for name in ("loss_gap", "grad_gap"):
        assert res["checks"][name]["value"] > res["checks"][name]["limit"]


def _edges_not_in_the_graph(monkeypatch):
    """The sampler's graph has every edge's source moved to the next
    node."""
    from stemgnn_tpu_torch.data import sampler
    inner = sampler.CSCGraph.from_edge_index
    monkeypatch.setattr(sampler.CSCGraph, "from_edge_index", staticmethod(
        lambda ei, n: inner(np.stack([(ei[0] + 1) % n, ei[1]]), n)))


def _over_the_fanout(monkeypatch):
    """The sampler takes one neighbour more a hop than the fanout."""
    from stemgnn_tpu_torch.train import pretrain_loop
    inner = pretrain_loop.NeighborBatchIterator
    monkeypatch.setattr(
        pretrain_loop, "NeighborBatchIterator",
        lambda csc, x, xe, seeds, bs, fanouts, rng, **kw: inner(
            csc, x, xe, seeds, bs, [f + 1 for f in fanouts], rng, **kw))


def _negatives_over_the_padding(monkeypatch):
    """The negative pairs are drawn over the padded rows too."""
    import torch

    from stemgnn_tpu_torch.train import pretrain_loop
    inner = pretrain_loop.draw_step

    def draw(cfg, graph, generator=None):
        out = inner(cfg, graph, generator)
        num, rows = out["neg"][0].shape[0], graph.node_feat.shape[0]
        out["neg"] = tuple(torch.randint(0, rows, (num,),
                                         generator=generator)
                           for _ in range(2))
        return out
    monkeypatch.setattr(pretrain_loop, "draw_step", draw)


@pytest.mark.parametrize("fault", [_edges_not_in_the_graph, _over_the_fanout,
                                   _negatives_over_the_padding],
                         ids=lambda f: f.__name__.strip("_"))
def test_sampled_batch_breaks_its_rules(monkeypatch, fault):
    """Both sides take the program's batches and draws, so only the
    reference's own check of them against the graph can fail these."""
    fault(monkeypatch)
    res = _run()
    assert res["correct"] is False
    assert res["checks"]["batch_faults"]["value"] >= 1


def test_step_answer_altered(monkeypatch):
    """The step reports a feature loss a thousandth off the one it trained
    on."""
    from stemgnn_tpu_torch.train import pretrain_loop
    inner = pretrain_loop.make_pretrain_step

    def altered(cfg, bs, generator=None):
        step = inner(cfg, bs, generator=generator)

        def run_step(*a, **k):
            out = step(*a, **k)
            out["feat_recon_loss"] = out["feat_recon_loss"] * 1.001
            return out
        return run_step
    monkeypatch.setattr(pretrain_loop, "make_pretrain_step", altered)
    res = _run()
    assert res["correct"] is False
    assert res["checks"]["feat_gap"]["value"] > res["checks"]["feat_gap"][
        "limit"]


def test_model_flops_of_a_batch_by_hand(monkeypatch):
    """Two batches of 2,000 nodes and 3,000 edges in all, 8,192 edge slots:
    n = 1,000, e = 1,500, 409 topo slots, 64 seeds, width 16, 2 heads of 8
    codes, 4 orthogonal codes.  mm(m, k, n) = 2 m k n.

      student  layer 1: 2 products x 2 passes 2,048,000 + e d 24,000;
               layer 2: 2 x 3 passes 3,072,000 + 2 e d 48,000
      teacher  2 x 1,024,000 + 2 x 24,000                    2,096,000
      trained x 3: VQ 2,048,000, orthogonal 1,024, feature 512,000, topo
               512,000 + 4 x 409 x 16, topo-sem 418,816, sem 512,000
                                                         3 x 4,030,016
      scores   512,000
      the feature decoder on the 64 seeds alone: less 3 x (512,000 -
      32,768) = 1,437,696"""
    from stemgnn_tpu_torch.core.config import PretrainConfig, from_dict
    from stemgnn_tpu_torch.data import sampler

    from benchmark.drivers import minibatch_pretrain
    w = tiny_mb_cell()
    cell = minibatch_pretrain.Cell(w, 0, "cpu")
    cell.cfg = from_dict(PretrainConfig(), w["conf"])
    monkeypatch.setattr(sampler, "batch_counts", collections.Counter(
        batches=2, nodes=2000, node_rows=2304, edges=3000, edge_slots=8192,
        truncations=0, escalations=0))
    student = 2_048_000 + 24_000 + 3_072_000 + 48_000
    trained = (2_048_000 + 1_024 + 512_000 + 512_000 + 4 * 409 * 16
               + 418_816 + 512_000)
    total = student + 2_096_000 + 3 * trained + 512_000 - 1_437_696
    assert cell.model_flops() == total == 18_452_352


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_an_empty_context(name):
    assert common.metric_reader(name).read({}) is None


def test_batch_idle_sweep_equals_idle_within():
    """The reader's one sweep gives ``spans.idle_within`` summed over the
    three batch spans, gaps crossing a range's ends included."""
    import random

    from benchmark import spans
    rnd = random.Random(3)
    merged, t = [], 0.0
    for _ in range(400):
        t += rnd.uniform(0.5, 20.0)
        merged.append([t, t + rnd.uniform(1.0, 30.0)])
        t = merged[-1][1]
    host, at = [], 0.0
    for _ in range(30):
        for name in ("sg:batch.sample", "sg:batch.layout",
                     "sg:batch.transfer", "sg:pretrain.step"):
            end = at + rnd.uniform(0.0, 300.0)
            host.append((name, at, end))
            at = end
    ctx = dict(trace=dict(merged=merged, host=host), units=30)
    want = sum(spans.idle_within(ctx, n) for n in (
        "sg:batch.sample", "sg:batch.layout", "sg:batch.transfer"))
    got = common.metric_reader("batch_idle_ms.mb").read(ctx)
    assert want > 0 and got == pytest.approx(want, rel=1e-12)
