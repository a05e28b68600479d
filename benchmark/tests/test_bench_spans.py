"""The readers of the program's spans (``benchmark/spans.py``) on contexts
built by hand: each gives the right number a unit, and None where the
context is empty or its span never ran."""

import pytest
import torch

from benchmark import common, spans

DEVICE = {  # span: device ms over the window's 4 units
    "sg:pretrain.student": 40.0, "sg:vq": 8.0, "sg:pretrain.losses": 20.0,
    "sg:pretrain.teacher": 12.0, "sg:train.backward": 80.0,
    "sg:agg": 16.0, "sg:agg.hub": 4.0, "sg:agg.masks.hub": 2.0,
    "sg:agg.masks.keep": 1.0, "sg:agg.masks.kept_deg": 3.0,
    "sg:finetune.train_step": 100.0, "sg:finetune.eval": 60.0}
WANT = {"student_ms.pretrain": 10.0, "vq_ms.pretrain": 2.0,
        "decode_ms.pretrain": 5.0, "teacher_ms.pretrain": 3.0,
        "backward_ms.pretrain": 20.0, "agg_ms.pretrain": 4.0,
        "agg_ms.finetune": 4.0, "agg_hub_ms.pretrain": 1.0,
        "agg_hub_ms.finetune": 1.0, "agg_masks_ms.pretrain": 1.5,
        "train_ms.finetune": 25.0, "eval_fwd_ms.finetune": 15.0}


def _ctx(host=(), merged=((0.0, 1.0),)):
    return dict(units=4, trace=dict(host=list(host), merged=list(merged),
                                    kernels=[], busy_s=0.0))


@pytest.fixture
def program(monkeypatch):
    """The program's recorder as ``DEVICE`` (a span of a name in the
    window: its device ms; ``sg:metrics.score``: host only)."""
    totals = {k: {"calls": 4, "device_ms": v, "host_ms": 1.0,
                  "parents": {None: 4}} for k, v in DEVICE.items()}
    totals["sg:metrics.score"] = {"calls": 12, "device_ms": None,
                                  "host_ms": 9.0, "parents": {None: 12}}
    monkeypatch.setattr(spans, "totals", lambda: totals)


@pytest.mark.parametrize("name", sorted(WANT))
def test_device_ms_readers(program, name):
    reader = common.metric_reader(name)
    assert reader.read(_ctx()) == pytest.approx(WANT[name])
    assert reader.read({}) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_device_ms_readers_without_the_span(monkeypatch, name):
    monkeypatch.setattr(spans, "totals", lambda: None)
    assert common.metric_reader(name).read(_ctx()) is None
    monkeypatch.setattr(spans, "totals", lambda: {"sg:other": {
        "calls": 1, "device_ms": 1.0, "host_ms": 1.0, "parents": {}}})
    assert common.metric_reader(name).read(_ctx()) is None


def test_dispatch_ms_reads_the_step_ranges_on_the_host():
    reader = common.metric_reader("dispatch_ms.pretrain")
    host = [("sg:pretrain.step", 0.0, 3000.0),
            ("sg:pretrain.step", 5000.0, 6000.0),
            ("aten::mm", 100.0, 200.0)]
    assert reader.read(_ctx(host)) == pytest.approx(1.0)   # 4 ms / 4
    # waits on a full launch queue, overlapping ones counted once, and a
    # wait outside the steps not at all
    full = spans.QUEUE_FULL
    host += [(full, 1000.0, 1800.0), (full, 1500.0, 2000.0),
             (full, 5500.0, 7000.0), (full, 8000.0, 9000.0)]
    assert reader.read(_ctx(host)) == pytest.approx((4000 - 1000 - 500)
                                                    / 1e3 / 4)
    assert reader.read(_ctx([("aten::mm", 0.0, 1.0)])) is None
    assert reader.read({}) is None


def test_score_idle_ms_counts_device_gaps_inside_the_scoring():
    """Device busy [0, 10], [20, 30], [50, 60] ms; the host scores over
    [5, 25] and [40, 70]: idle inside them is [10, 20] and [40, 50]."""
    reader = common.metric_reader("score_idle_ms.finetune")
    merged = [(0.0, 1e4), (2e4, 3e4), (5e4, 6e4)]
    host = [("sg:metrics.score", 5e3, 25e3),
            ("sg:metrics.score", 40e3, 70e3),
            ("sg:finetune.eval", 0.0, 60e3)]
    assert reader.read(_ctx(host, merged)) == pytest.approx(20.0 / 4)
    # a gap the scoring does not overlap counts nothing
    assert reader.read(_ctx([("sg:metrics.score", 0.0, 5e3)],
                            merged)) == 0.0
    assert reader.read(_ctx([], merged)) is None
    assert reader.read({}) is None


def test_totals_is_the_programs_recorder():
    from stemgnn_tpu_torch.utils import trace
    trace.take()
    with trace.enabled():
        with trace.span("sg:vq"):
            torch.zeros(1)
    assert spans.totals()["sg:vq"]["calls"] == 1
    trace.take()
