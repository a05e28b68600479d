"""The yardstick's counts on shapes checked by hand."""

import numpy as np
import pytest

from benchmark.work import aggregation, model_flops


def test_aggregation_bytes_and_flops():
    # 4 edges over 3 nodes, width 2; node 2 sends nothing
    senders = np.array([0, 1, 1, 0])
    w = aggregation.sage_mean(senders, n=3, d=2)
    # x rows of 2 senders and g rows of 2 receivers, 8 B each; edges 8 B
    # each; the type row 8 B; out and dx 3 rows each
    assert w["bytes"] == (2 + 2) * 8 + 4 * 8 + 8 + 2 * 3 * 8
    assert w["flops"] == 3 * 4 * 2 + 3 * 3 * 2
    assert w["distinct_senders"] == 2 and w["edges"] == 4


def test_aggregation_receivers_counted_apart():
    w = aggregation.sage_mean(np.array([0, 0]), n=4, d=1,
                              receivers=np.array([1, 2]))
    assert w["bytes"] == (1 + 2) * 4 + 2 * 8 + 4 + 2 * 4 * 4


def _conf(layers=2, normalize="batch"):
    return {"encoder": {"input_dim": 4, "hidden_dim": 4,
                        "num_layers": layers, "normalize": normalize},
            "vq": {"heads": 2, "codebook_dim": 4, "codebook_size": 3,
                   "orthogonal_reg_max_codes": 2},
            "num_classes": 5}


def test_encoder_flops_by_hand():
    # n = 10 rows, e = 7 edges, width 4: a product is 2 * 10 * 4 * 4 = 320
    enc = _conf()["encoder"]
    # trained: layer 1 (fwd + weight grad) 2 products x 2 passes, its
    # aggregation once; layer 2 three passes, its aggregation twice
    assert model_flops._encoder(enc, 10, 7, True) == (
        2 * 2 * 320 + 7 * 4 + 3 * 2 * 320 + 2 * 7 * 4)
    assert model_flops._encoder(enc, 10, 7, False) == 4 * 320 + 2 * 7 * 4


def test_finetune_epoch_by_hand():
    c = _conf()
    n, e = 10, 7
    enc_train = model_flops._encoder(c["encoder"], n, e, True)
    enc_eval = model_flops._encoder(c["encoder"], n, e, False)
    project_in = 2 * n * 4 * 8
    scores = 2 * 2 * n * 4 * 3
    decoder = 2 * n * 8 * 10
    want = (enc_train + 2 * project_in + scores + 3 * decoder
            + enc_eval + project_in + scores + decoder)
    assert model_flops.finetune_epoch(c, n, e) == pytest.approx(want)


def test_pretrain_step_by_hand():
    c = _conf()
    n, e, slots = 10, 7, 3
    trained = (2 * n * 4 * 8 + 2 * n * 8 * 4 + 2 * (2 * 2 * 4 * 2)
               + 2 * n * 4 * 4 + 2 * n * 4 * 4 + 2 * 2.0 * slots * 4
               + 2 * slots * 8 * 4 + 2 * n * 4 * 4)
    want = (model_flops._encoder(c["encoder"], n, e, True) + 3 * trained
            + 2 * 2 * n * 4 * 3 + model_flops._encoder(c["encoder"], n, e,
                                                       False))
    assert model_flops.pretrain_step(c, n, e, slots) == pytest.approx(want)


def test_full_size_counts():
    """The two cells' counts at their sizes, for PERF.md's predictions."""
    import os
    from benchmark import common
    pt = common.load_json(os.path.join(
        common.HERE, "configs", "stemgnn-pretrain-sage768-vq4x128.json"))
    ft = common.load_json(os.path.join(
        common.HERE, "configs", "stemgnn-finetune-arxiv-node.json"))
    n, e = 169343, 2370802
    assert 1.0e13 < model_flops.pretrain_step(pt, n, e, 237081) < 1.3e13
    assert 5.5e12 < model_flops.finetune_epoch(ft, n, e) < 6.5e12
