"""A whole run with the timed path broken underneath, past the harness's
look for a card: each fault a cell can have reads ``correct`` false.

The cells run on one chip, so the fault of an exchange between chips left
out has no path here; a pretrain step has no answer to alter."""

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import tiny_cell


def _run(name):
    return run.run_cell(tiny_cell(name), 3 * 2 ** 31 + 7, 0.3, False,
                        device="cpu")


def test_pretrain_step_leaves_its_state_unchanged(monkeypatch):
    from stemgnn_tpu_torch.train import optim
    monkeypatch.setattr(optim.Optimizer, "step", lambda self: None)
    res = _run("pretrain.full.arxiv")
    assert res["correct"] is False
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_finetune_step_leaves_its_state_unchanged(monkeypatch):
    from stemgnn_tpu_torch.train import finetune_loop
    monkeypatch.setattr(finetune_loop, "_apply", lambda *a, **k: None)
    res = _run("finetune.node.arxiv")
    assert res["correct"] is False
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def _every_other(mask):
    return mask & (torch.arange(mask.shape[0], device=mask.device) % 2 == 0)


def test_pretrain_leaves_half_the_batch_out(monkeypatch):
    import dataclasses

    from stemgnn_tpu_torch.train import pretrain_loop
    inner = pretrain_loop.pretrain_forward

    def half(model, teacher, cfg, aug_g, orig_g, **kw):
        aug_g = dataclasses.replace(aug_g,
                                    node_mask=_every_other(aug_g.node_mask))
        orig_g = dataclasses.replace(orig_g,
                                     node_mask=_every_other(orig_g.node_mask))
        return inner(model, teacher, cfg, aug_g, orig_g, **kw)
    monkeypatch.setattr(pretrain_loop, "pretrain_forward", half)
    res = _run("pretrain.full.arxiv")
    assert res["correct"] is False


def test_finetune_leaves_half_the_batch_out(monkeypatch):
    from stemgnn_tpu_torch.train import finetune_loop
    inner = finetune_loop._loss_parts

    def half(model, cfg, rows, y, row_mask, train_mask, aux, valid=None):
        return inner(model, cfg, rows, y, row_mask, _every_other(train_mask),
                     aux, valid)
    monkeypatch.setattr(finetune_loop, "_loss_parts", half)
    res = _run("finetune.node.arxiv")
    assert res["correct"] is False


def test_finetune_answer_altered_where_produced(monkeypatch):
    from stemgnn_tpu_torch.train import finetune_loop
    inner = finetune_loop._make_node_steps

    def altered(cfg, task_kind="node"):
        loss_fn, train_step, eval_step = inner(cfg, task_kind)

        def eval_altered(model, graph, plain=False):
            probs = eval_step(model, graph, plain).clone()
            probs[7] = probs[7].roll(1)
            return probs
        return loss_fn, train_step, eval_altered
    monkeypatch.setattr(finetune_loop, "_make_node_steps", altered)
    res = _run("finetune.node.arxiv")
    assert res["correct"] is False
    assert res["checks"]["prob_gap"]["value"] > res["checks"]["prob_gap"][
        "limit"]
