"""The port's span recorder (``stemgnn_tpu_torch.utils.trace``): a span
costs nothing with tracing off, records its parent across autograd's
threads, and one pretrain step and one finetune epoch under
``torch.profiler`` emit exactly the documented ``sg:`` spans.  Torch only,
on the CPU."""

import os
import re
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import synthetic
from stemgnn_tpu_torch.models.pretrain import PretrainModel, make_teacher
from stemgnn_tpu_torch.models.task import task_model_init
from stemgnn_tpu_torch.train.finetune_loop import (_make_node_steps,
                                                   _split_params,
                                                   make_optimizer)
from stemgnn_tpu_torch.train.graph_setup import fused_full_graph
from stemgnn_tpu_torch.train.pretrain_loop import (make_pretrain_optimizer,
                                                   make_pretrain_step)
from stemgnn_tpu_torch.utils import trace
from stemgnn_tpu_torch.utils.metrics import evaluate

D, N = 32, 512
PORT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "stemgnn_tpu_torch")


@pytest.fixture(autouse=True)
def _empty_recorder():
    trace.take()
    yield
    trace.take()


@pytest.fixture(scope="module")
def data():
    # the first AdamW imports PyTorch's compiler stack (~2 s): once, here
    torch.optim.AdamW([torch.zeros(1, requires_grad=True)])
    return synthetic.synthetic_node_dataset(
        num_nodes=N, num_classes=5, feat_dim=D, avg_degree=8,
        pref_attach=1.1, num_splits=1, seed=3)


def _graph(ds, encoder):
    g = fused_full_graph(ds, pcfg.FinetuneConfig(
        encoder=encoder, hub_size=64, sc_hub_size=64), device="cpu",
        use_layout=True)
    assert g.layout.hub_r is not None and g.layout.hub_s is not None
    return g


def _shape(spans):
    return {k: (t["calls"], t["parents"]) for k, t in spans.items()}


def _profiled_names(prof):
    out = {}
    for e in prof.events():
        if e.name.startswith("sg:"):
            out[e.name] = out.get(e.name, 0) + 1
    return out


def test_span_with_tracing_off_makes_no_cuda_call_and_records_nothing(
        monkeypatch, data):
    """No profiler, no ``enabled``: a span is the shared no-op even where
    CUDA is initialized, and a whole finetune step records nothing."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA event was made")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert not trace.tracing()
    assert trace.span("sg:x") is trace.span("sg:y")
    with trace.span("sg:x"):
        pass
    cfg = pcfg.FinetuneConfig(
        encoder=pcfg.EncoderConfig(input_dim=D, hidden_dim=D),
        vq=pcfg.VQConfig(dim=D, codebook_dim=D, codebook_size=8, heads=2),
        num_classes=5)
    g = data.to_graph()
    model = task_model_init(cfg, generator=torch.Generator().manual_seed(0))
    model.vq.initted.fill_(True)
    opt = make_optimizer(_split_params(model, cfg)[0], cfg)
    _, train_step, _ = _make_node_steps(cfg, "node")
    y = torch.zeros(g.num_nodes_padded, dtype=torch.long)
    train_step(model, opt, g.node_mask, g, y)
    assert trace.totals() == {}


def test_span_is_a_noop_while_torch_compile_traces():
    def f(x):
        with trace.span("sg:inner"):
            return x * 2 + 1
    compiled = torch.compile(f, backend="eager", fullgraph=True)
    with trace.enabled():
        out = compiled(torch.ones(3))
    assert torch.equal(out, torch.full((3,), 3.0))
    assert "sg:inner" not in trace.totals()


def test_recorder_parents_threads_and_same_name_spans():
    """A loop's recorder records with tracing off; a span on a thread with
    none open names the span open elsewhere; a span inside one of its own
    name is the same span; ``take`` clears, ``totals`` does not."""
    rec = trace.Recorder("cpu")
    seen = {}

    def worker():
        with trace.span("sg:child", rec):
            seen["parent"] = rec
    with trace.span("sg:outer", rec):
        with trace.span("sg:outer"):       # the step's own span
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
    assert not t.is_alive() and seen
    got = rec.totals()
    assert _shape(got) == {"sg:outer": (1, {None: 1}),
                           "sg:child": (1, {"sg:outer": 1})}
    assert got["sg:outer"]["device_ms"] is None
    assert got["sg:outer"]["host_ms"] >= got["sg:child"]["host_ms"] > 0
    assert rec.ms("sg:outer") == [] and len(rec.ms("sg:outer", False)) == 1
    assert trace.totals() == {}            # tracing was off
    assert rec.take() == got and rec.totals() == {}
    with trace.enabled():
        with trace.span("sg:outer", rec):
            pass
    assert rec.totals()["sg:outer"]["calls"] == 1
    assert trace.totals()["sg:outer"]["calls"] == 1


def test_pretrain_step_emits_the_documented_spans(data):
    """One full-graph pretrain step with the pair-hash dropout on a hub
    layout: the step's children partition it; ``sg:agg`` runs 5 times (2
    layers x the student's and the teacher's forward, and layer 2's
    backward: layer 1's input needs no gradient); each mask kind once."""
    cfg = pcfg.PretrainConfig(
        encoder=pcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="batch", dropout=0.15),
        vq=pcfg.VQConfig(dim=D, codebook_size=16, codebook_dim=D, heads=2,
                         orthogonal_reg_max_codes=8), batch_size=0)
    g = _graph(data, cfg.encoder)
    model = PretrainModel(cfg, generator=torch.Generator().manual_seed(0))
    teacher = make_teacher(model)
    step = make_pretrain_step(cfg, bs=N,
                              generator=torch.Generator().manual_seed(1))
    opt = make_pretrain_optimizer(model, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, teacher, opt, g)
    got = trace.take()
    root = "sg:pretrain.step"
    assert _shape(got) == {
        root: (1, {None: 1}),
        "sg:pretrain.student": (2, {root: 2}),
        "sg:vq": (1, {root: 1}),
        "sg:pretrain.losses": (2, {root: 2}),
        "sg:pretrain.teacher": (1, {root: 1}),
        "sg:train.backward": (1, {root: 1}),
        "sg:train.update": (1, {root: 1}),
        "sg:agg": (5, {"sg:pretrain.student": 2, "sg:pretrain.teacher": 2,
                       "sg:train.backward": 1}),
        "sg:agg.hub": (5, {"sg:agg": 5}),
        "sg:agg.masks.kept_deg": (1, {"sg:agg": 1}),
        "sg:agg.masks.hub": (1, {"sg:agg": 1}),
        "sg:agg.masks.keep": (1, {"sg:agg": 1})}
    assert _profiled_names(prof) == {k: t["calls"] for k, t in got.items()}
    assert all(t["device_ms"] is None for t in got.values())


def test_finetune_epoch_emits_the_documented_spans(data):
    """One epoch as the benchmark's driver runs it: the training step, the
    evaluation forward, the readback and three scores on the host."""
    cfg = pcfg.FinetuneConfig(
        encoder=pcfg.EncoderConfig(input_dim=D, hidden_dim=D,
                                   normalize="none"),
        vq=pcfg.VQConfig(dim=D, codebook_dim=D, codebook_size=16, heads=2,
                         commitment_weight=0.25), num_classes=5)
    g = _graph(data, cfg.encoder)
    model = task_model_init(cfg, generator=torch.Generator().manual_seed(0))
    model.vq.initted.fill_(True)
    opt = make_optimizer(_split_params(model, cfg)[0], cfg)
    _, train_step, eval_step = _make_node_steps(cfg, "node")
    n_pad = g.num_nodes_padded
    y = np.zeros(n_pad, np.int64)
    y[:N] = data.labels
    masks = {k: np.arange(n_pad) < 0 for k in ("train", "valid", "test")}
    for k in masks:
        masks[k][:N] = data.splits[0][k]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(model, opt, torch.from_numpy(masks["train"]), g,
                   torch.from_numpy(y), torch.Generator().manual_seed(2))
        pred = np.asarray(eval_step(model, g).cpu())
        for k in masks:
            evaluate(pred, y, masks[k], "node")
    got = trace.take()
    root = "sg:finetune.train_step"
    assert _shape(got) == {
        root: (1, {None: 1}),
        "sg:finetune.forward": (1, {root: 1}),
        "sg:train.backward": (1, {root: 1}),
        "sg:train.update": (1, {root: 1}),
        "sg:finetune.eval": (1, {None: 1}),
        "sg:vq": (2, {"sg:finetune.forward": 1, "sg:finetune.eval": 1}),
        "sg:agg": (5, {"sg:finetune.forward": 2, "sg:train.backward": 1,
                       "sg:finetune.eval": 2}),
        "sg:agg.hub": (5, {"sg:agg": 5}),
        "sg:metrics.score": (3, {None: 3})}
    assert _profiled_names(prof) == {k: t["calls"] for k, t in got.items()}


def _sources(*subdirs):
    for sub in subdirs:
        for root, _, files in os.walk(os.path.join(PORT, sub)):
            for f in files:
                if f.endswith(".py"):
                    path = os.path.join(root, f)
                    with open(path) as fh:
                        yield os.path.relpath(path, PORT), fh.read()


def test_one_recorder_times_the_loops():
    """The loops time through ``utils.trace`` alone: no CUDA event of their
    own, and none of the timers it replaced."""
    events = [p for p, src in _sources("train", "eval", "parallel", "ofa",
                                       "data") if "cuda.Event" in src]
    assert events == []
    gone = re.compile(r"SpanTimer|_Events\b|ThroughputMeter|drop_hash:")
    assert [p for p, src in _sources("") if gone.search(src)] == []
