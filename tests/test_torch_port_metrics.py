"""The port's accuracy scoring (``stemgnn_tpu_torch.utils.metrics``): the
native one-pass scorer (``csrc/metrics.cpp``) against numpy's argmax and
the JAX package's ``eval_acc``, bit for bit, ties and NaNs included; which
inputs take which path (``score_counts``); the numpy fallback when the
scorer cannot be built; and ``run_finetune``'s epochs scored natively."""

import numpy as np
import pytest

from stemgnn_tpu.utils import metrics as jax_metrics
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import native_sampler
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.train import finetune_loop as port_ft
from stemgnn_tpu_torch.utils import metrics, native_build

# the benchmark's arxiv graph: 169,343 nodes padded to 169,344, 40 classes,
# ogbn-arxiv's split
ARXIV_N, ARXIV_PAD, ARXIV_C = 169_343, 169_344, 40
ARXIV_SPLIT = (90_941, 29_799, 48_603)


def _probs(rng, n, c, scale=3.0):
    logits = rng.standard_normal((n, c)) * scale
    p = np.exp(logits - logits.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


def _split_masks(rng, n, n_pad, sizes):
    perm = rng.permutation(n)
    masks, start = [], 0
    for size in sizes:
        m = np.zeros(n_pad, bool)
        m[perm[start:start + size]] = True
        masks.append(m)
        start += size
    return masks


def _tied_rows(rng, n, c, first):
    """Rows whose maximum is shared by 2-3 of the first ``first`` columns
    (across the 8-column lanes the vector path reads), labels drawn from
    the tied columns, so the first of them decides a hit."""
    p = rng.random((n, c)).astype(np.float32) * 0.5
    tied = []
    for r in range(n):
        cols = rng.choice(min(first, c), size=max(1, min(3, c) - r % 2),
                          replace=False)
        p[r, cols] = 0.75
        tied.append(cols)
    y = np.array([rng.choice(cols) for cols in tied], np.int64)
    return p, y


def _case_split_sizes(rng):
    p = _probs(rng, ARXIV_PAD, ARXIV_C)
    y = np.zeros(ARXIV_PAD, np.int64)
    # about half the rows hit: the label is the argmax or a random class
    y[:ARXIV_N] = np.where(rng.random(ARXIV_N) < 0.5,
                           p[:ARXIV_N].argmax(-1),
                           rng.integers(0, ARXIV_C, ARXIV_N))
    return p, y, _split_masks(rng, ARXIV_N, ARXIV_PAD, ARXIV_SPLIT)


def _case_whole_row_ties(rng):
    n, c = 2_000, 40
    p = _probs(rng, n, c)
    p[::3] = np.float32(1.0 / c)           # every column ties
    p[1::7] = np.float32(0.0)
    p[2::11] = np.float32(-0.0)
    p[5::13, ::2] = np.float32(0.0)        # +0.0 and -0.0 tie
    p[5::13, 1::2] = np.float32(-0.0)
    p[4::17] = -np.inf
    y = rng.integers(0, 3, n)              # class 0 hits a tied row
    return p, y, _split_masks(rng, n, n, (1_000, 600))


def _case_ties_at_first_columns(rng):
    p, y = _tied_rows(rng, 3_000, 40, 12)
    p[::5, 20] = np.inf                    # a second tie, at +inf
    p[::5, 3] = np.inf
    return p, y, _split_masks(rng, 3_000, 3_000, (1_500, 700, 800))


def _case_nan_rows(rng):
    n, c = 3_000, 40
    p = _probs(rng, n, c)
    rows = rng.choice(n, 400, replace=False)
    first = rng.integers(0, c, 400)
    p[rows, first] = np.nan
    p[rows[:100], (first[:100] + 7) % c] = np.nan   # a second NaN
    p[rows[100:150], 0] = np.nan                    # NaN in column 0
    p[::97] = np.nan                                # all NaN
    y = p.argmax(-1).astype(np.int64)
    y[::2] = rng.integers(0, c, len(y[::2]))
    return p, y, _split_masks(rng, n, n, (1_800, 600, 600))


def _case_mask_none(rng):
    p = _probs(rng, 5_000, 40)
    y = np.where(rng.random(5_000) < 0.6, p.argmax(-1),
                 rng.integers(0, 40, 5_000))
    return p, y, [None]


def _case_empty_mask(rng):
    p = _probs(rng, 500, 40)
    return p, p.argmax(-1), [np.zeros(500, bool)]


def _case_int32_labels(rng):
    p, y, masks = _case_ties_at_first_columns(rng)
    return p, y.astype(np.int32), masks + [None]


def _case_widths(rng):
    """Widths around the vector path's range (8 to 64 columns) and its
    8-column lanes, with ties, NaNs and labels outside the classes."""
    out = []
    for c in (1, 2, 7, 8, 9, 16, 33, 63, 64, 65, 100):
        p, y = _tied_rows(rng, 400, c, c)
        p[::9, rng.integers(0, c)] = np.nan
        y[::13] = c + 1
        y[1::13] = -1
        out.append((p, y, [None] + _split_masks(rng, 400, 400, (200, 100))))
    return out


CASES = {
    "split_sizes": _case_split_sizes,
    "whole_row_ties": _case_whole_row_ties,
    "ties_at_first_columns": _case_ties_at_first_columns,
    "nan_rows": _case_nan_rows,
    "mask_none": _case_mask_none,
    "empty_mask": _case_empty_mask,
    "int32_labels": _case_int32_labels,
    "widths": _case_widths,
}


def _numpy_acc(pred, y, mask):
    if mask is not None:
        pred, y = pred[mask], y[mask]
    if len(y) == 0:
        return float("nan")
    return float((np.argmax(pred, -1) == y).mean())


def _same(a, b):
    return np.float64(a).tobytes() == np.float64(b).tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_accuracy_matches_numpy_and_jax(case):
    """Every evaluation of the case takes the native path and returns the
    float numpy's argmax gives, bit for bit, and the JAX package's."""
    made = CASES[case](np.random.default_rng(sorted(CASES).index(case)))
    calls = 0
    before = dict(metrics.score_counts)
    for pred, y, masks in made if isinstance(made, list) else [made]:
        assert pred.dtype == np.float32 and pred.flags.c_contiguous
        for mask in masks:
            got = metrics.eval_acc(pred, y, mask)
            calls += 1
            want = _numpy_acc(pred, y, mask)
            assert _same(got, want), (case, got, want)
            assert _same(got, jax_metrics.eval_acc(pred, y, mask)), case
            assert _same(metrics.evaluate(pred, y, mask, "node"),
                         jax_metrics.evaluate(pred, y, mask, "node"))
            calls += 1
    assert metrics.score_counts["native"] - before["native"] == calls
    assert metrics.score_counts["numpy"] == before["numpy"]
    if case == "empty_mask":
        assert np.isnan(got)


def test_other_inputs_take_the_numpy_path():
    """float64, strided and Fortran-ordered probabilities, an int mask,
    float and uint64 labels take numpy's code with the same answers;
    float32 C-contiguous ones the native pass, a list of bools as a mask
    too.  The counts say which; a mask of another length and a width of
    zero raise numpy's errors."""
    rng = np.random.default_rng(7)
    p = _probs(rng, 1_000, 40)
    y = rng.integers(0, 40, 1_000)
    mask = rng.random(1_000) < 0.5
    numpy_inputs = [
        (p.astype(np.float64), y, mask),
        (_probs(rng, 1_000, 80)[:, ::2], y, mask),      # strided view
        (np.asfortranarray(p), y, mask),
        (p, y, mask.astype(np.int64)),                  # int mask
        (p, y.astype(np.float64), mask),                # float labels
        (p, y.astype(np.uint64), None),
    ]
    for k in metrics.score_counts:
        metrics.score_counts[k] = 0
    for pred, labels, m in numpy_inputs:
        assert _same(metrics.eval_acc(pred, labels, m),
                     jax_metrics.eval_acc(pred, labels, m))
    assert metrics.score_counts == {"native": 0, "numpy": len(numpy_inputs)}
    assert _same(metrics.eval_acc(p, y, mask), _numpy_acc(p, y, mask))
    assert _same(metrics.eval_acc(p, y.astype(np.int16), mask.tolist()),
                 _numpy_acc(p, y, mask))                # a list of bools
    assert metrics.score_counts == {"native": 2, "numpy": len(numpy_inputs)}
    with pytest.raises(IndexError):                     # numpy's error
        metrics.eval_acc(p, y, mask[:10])
    with pytest.raises(ValueError):                     # no columns
        metrics.eval_acc(np.zeros((4, 0), np.float32), np.zeros(4, int))


def test_failed_build_falls_back_to_numpy_with_one_warning(
        monkeypatch, tmp_path, capsys):
    """A compiler that fails costs speed only: the same answers from numpy,
    one line on standard error however many calls follow."""
    monkeypatch.setattr(metrics, "_lib", None)
    monkeypatch.setattr(native_build, "CXX", "false")
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    rng = np.random.default_rng(3)
    p, y, masks = _case_nan_rows(rng)
    before = dict(metrics.score_counts)
    for m in masks:
        assert _same(metrics.eval_acc(p, y, m), _numpy_acc(p, y, m))
    err = capsys.readouterr().err
    assert err.count("scored with numpy") == 1 and "false" in err
    assert metrics.score_counts["numpy"] - before["numpy"] == len(masks)
    assert metrics.score_counts["native"] == before["native"]
    assert list(tmp_path.iterdir()) == []


def test_host_libraries_share_one_build_helper():
    """The sampler and the scorer build through ``utils.native_build`` into
    the same directory, each named by its source's stem and hash."""
    scorer = native_build.build(metrics.SOURCE, "the accuracy scorer")
    sampler = native_sampler.build()
    assert {p.rsplit("/", 1)[1].split("-")[0] for p in (scorer, sampler)} \
        == {"metrics", "sampler"}
    assert {p.rsplit("/", 1)[0] for p in (scorer, sampler)} == \
        {native_build.BUILD_DIR}
    assert native_sampler.library_path() == sampler


def test_run_finetune_scores_every_epoch_natively():
    """Each full-batch epoch of ``run_finetune`` scores train, valid and
    test through the native pass; its history counts them."""
    d = 16
    cfg = pcfg.FinetuneConfig(
        encoder=pcfg.EncoderConfig(input_dim=d, hidden_dim=d, dropout=0.0),
        vq=pcfg.VQConfig(dim=d, codebook_size=8, codebook_dim=d, heads=2,
                         commitment_weight=0.25, kmeans_init=True),
        task="node", num_classes=5, epochs=2, repeat=1)
    ds = port_synthetic.synthetic_node_dataset(
        num_nodes=200, num_classes=5, feat_dim=d, avg_degree=6,
        pref_attach=1.1, num_splits=1, seed=3)
    res = port_ft.run_finetune(ds, cfg, device="cpu")
    assert [h["score_counts"] for h in res["history"]] == \
        [{"native": 3, "numpy": 0}] * 2
