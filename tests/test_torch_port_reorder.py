"""The port's locality relabel (stemgnn_tpu_torch/ops/reorder.py, the two
benchmark generators of data/synthetic.py and train/graph_setup.py's
``reorder_dataset`` / ``maybe_reorder_dataset``) against the JAX package's.

The orders, ``relabel`` and the generators are numpy on both sides and must
be equal bit for bit.  The ``auto`` probe under the ``V5E`` profile must
pick the candidate JAX's probe picks (JAX probes only on its TPU, so the
test runs JAX's probe loop itself with the same profile).  A finetune over
the relabelled dataset gives the unrelabelled run's losses to 1e-5."""

import dataclasses

import numpy as np
import pytest
import torch

from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.ops import chip_profile as jax_profile
from stemgnn_tpu.ops import edge_layout as jax_el
from stemgnn_tpu.ops import reorder as jax_reorder
from stemgnn_tpu.train import graph_setup as jax_setup
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.data.dataset import TAGDataset
from stemgnn_tpu_torch import profile_reorder
from stemgnn_tpu_torch.ops import reorder as port_reorder
from stemgnn_tpu_torch.ops.chip_profile import V5E
from stemgnn_tpu_torch.train import finetune_loop as port_ft
from stemgnn_tpu_torch.train import graph_setup as port_setup


def _graphs():
    """Edge lists with several components, isolated nodes (ids no edge
    names, among them the last), parallel edges and self loops."""
    rng = np.random.default_rng(0)
    out = {}
    # two power-law blocks plus a chain, nodes 700-799 isolated
    a = rng.integers(0, 300, (2, 2000))
    b = rng.integers(300, 600, (2, 1500))
    chain = np.stack([np.arange(600, 699), np.arange(601, 700)])
    out["components"] = (np.concatenate([a, b, chain], 1), 800)
    # a shuffled community graph (the relabels' target)
    _, s, r, _ = jax_synthetic.community_power_law_graph(
        3000, 20000, 4, num_communities=12, seed=1)
    out["community"] = (np.stack([s, r]), 3000)
    # parallel edges and self loops
    e = rng.integers(0, 50, (2, 400))
    e[:, :50] = e[0, :50]
    out["multi"] = (np.concatenate([e, e[:, :100]], 1), 64)
    return out


GRAPHS = _graphs()


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("method", ["degree_order", "rcm_order",
                                    "community_order"])
def test_orders_and_relabel_equal_jax_bit_for_bit(method, graph):
    ei, n = GRAPHS[graph]
    want = getattr(jax_reorder, method)(ei[0], ei[1], n)
    got = getattr(port_reorder, method)(ei[0], ei[1], n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(n))
    feats = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    ws, wr, (wf,) = jax_reorder.relabel(want, ei[0], ei[1], (feats,))
    gs, gr, (gf,) = port_reorder.relabel(got, ei[0], ei[1], (feats,))
    for g, w in ((gs, ws), (gr, wr), (gf, wf)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_label_propagations_order_as_jax(graph):
    """Both label propagations of ``profile_reorder`` (the port's and the
    reference's loop it times) order the nodes as JAX's ``community_order``
    without its community chain."""
    ei, n = GRAPHS[graph]
    want = jax_reorder.community_order(ei[0], ei[1], n, refine_rcm=False)
    for fn in (port_reorder.propagate_labels,
               profile_reorder.reference_propagate_labels):
        lab = fn(ei[0], ei[1], n)
        np.testing.assert_array_equal(
            np.lexsort((np.arange(n), lab)).astype(np.int64), want)


def test_profile_reorder_runs(capsys):
    profile_reorder.main(["--dataset", "cora_synthetic", "--feat_dim", "16",
                          "--reps", "1"])
    assert "the two label propagations give the same labels" in \
        capsys.readouterr().out


@pytest.mark.parametrize("name,kw", [
    ("random_power_law_graph", dict(num_nodes=2000, num_edges=9000,
                                    feat_dim=6, seed=4)),
    ("random_power_law_graph", dict(num_nodes=500, num_edges=3000,
                                    feat_dim=5, alpha=1.2, seed=2,
                                    with_edge_feat=False)),
    ("community_power_law_graph", dict(num_nodes=2050, num_edges=9000,
                                       feat_dim=6, num_communities=16,
                                       seed=5)),
    ("community_power_law_graph", dict(num_nodes=900, num_edges=4000,
                                       feat_dim=3, shuffle=False,
                                       with_edge_feat=True, seed=6)),
])
def test_generators_equal_jax_bit_for_bit(name, kw):
    want = getattr(jax_synthetic, name)(**kw)
    got = getattr(port_synthetic, name)(**kw)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w)


def _same_dataset(got, want):
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "extras":
            assert sorted(g) == sorted(w)
            for k in w:
                assert np.array_equal(g[k], np.asarray(w[k])), k
        elif f.name == "splits":
            assert (g is None) == (w is None)
            for a, b in zip(g or [], w or []):
                assert sorted(a) == sorted(b)
                assert all(np.array_equal(a[k], np.asarray(b[k])) for k in b)
        elif isinstance(w, np.ndarray) or hasattr(w, "shape"):
            assert np.array_equal(np.asarray(g), np.asarray(w)), f.name
        else:
            assert g == w, f.name


@pytest.mark.parametrize("task", ["node", "link"])
@pytest.mark.parametrize("method", ["rcm", "community", "degree"])
def test_reorder_dataset_equals_jax_field_for_field(task, method):
    if task == "node":
        kw = dict(num_nodes=500, num_classes=4, feat_dim=8, num_splits=2,
                  train_per_split=50, val_per_split=100, seed=2)
        ds_j = jax_synthetic.synthetic_node_dataset(**kw)
        ds_p = port_synthetic.synthetic_node_dataset(**kw)
    else:
        kw = dict(num_entities=300, num_edges=1500, feat_dim=8, seed=2)
        ds_j = jax_synthetic.synthetic_link_dataset(**kw)
        ds_p = port_synthetic.synthetic_link_dataset(**kw)
    # an underscore extra (a cached host structure) is dropped
    ds_j.extras["_cache"] = ds_p.extras["_cache"] = np.zeros(3)
    got = port_setup.reorder_dataset(ds_p, method, task)
    want = jax_setup.reorder_dataset(ds_j, method, task)
    _same_dataset(got, want)
    assert "_cache" not in got.extras
    perm = got.extras["node_perm"]
    if task == "link":       # per-edge labels and splits keep their slots
        assert np.array_equal(got.labels, ds_p.labels)
        for a, b in zip(got.splits, ds_p.splits):
            assert all(np.array_equal(a[k], b[k]) for k in b)
    else:
        assert np.array_equal(got.labels, ds_p.labels[perm])
    # node i of the new graph is node perm[i] of the old one
    inv = np.argsort(perm)
    assert np.array_equal(got.edge_index, inv[ds_p.edge_index])
    with pytest.raises(ValueError):
        port_setup.reorder_dataset(ds_p, "spectral", task)


def _community_ds(shuffle: bool):
    n, e = 20000, 140000
    _, s, r, _ = port_synthetic.community_power_law_graph(
        n, e, 8, seed=0, num_communities=64, shuffle=shuffle)
    ei = np.stack([s, r]).astype(np.int64)
    return TAGDataset(name="community", node_text_feat=np.zeros((1, 768),
                                                                np.float32),
                      edge_text_feat=np.zeros((1, 768), np.float32),
                      x=np.zeros(n, np.int64), xe=np.zeros(e, np.int64),
                      edge_index=ei, labels=np.arange(n) % 5)


def _jax_probe(ds):
    """JAX ``maybe_reorder_dataset``'s auto loop under the v5e profile:
    the method it relabels with, or None."""
    jax_profile.set_profile(jax_profile._V5E)
    try:
        n_pad = ((ds.num_nodes + 127) // 128) * 128
        for method in ("community", "rcm"):
            cand = jax_setup.reorder_dataset(ds, method, "node")
            probe = jax_el.build_edge_layout(
                np.asarray(cand.edge_index[0], np.int32),
                np.asarray(cand.edge_index[1], np.int32), n_pad,
                to_device=False, feat_dim_hint=768, loc_split="auto")
            if (probe.use_gwin_r or probe.use_gwin_s
                    or probe.split_r is not None
                    or probe.split_s is not None):
                return method
        return None
    finally:
        jax_profile.set_profile(None)


def test_auto_probe_under_v5e_picks_jax_candidate(capsys):
    """The shuffled community graph: the original's gate is shut under
    ``V5E``, JAX's probe relabels with ``community`` (its local/stray
    split clears the gate), and the port's ``auto`` returns that
    relabel.  Under the H100 profile ``auto`` leaves the graph as it
    is (the gate is open already)."""
    ds = _community_ds(shuffle=True)
    cfg = dataclasses.replace(pcfg.FinetuneConfig(), reorder="auto")
    method = _jax_probe(ds)
    assert method == "community"
    got = port_setup.maybe_reorder_dataset(ds, cfg, "node", "cuda",
                                           profile=V5E)
    want = port_setup.reorder_dataset(ds, method, "node")
    assert np.array_equal(got.edge_index, want.edge_index)
    assert np.array_equal(got.extras["node_perm"], want.extras["node_perm"])
    assert "community relabel enables local/stray split" in \
        capsys.readouterr().out
    h100 = port_setup.maybe_reorder_dataset(ds, cfg, "node", "cuda",
                                            profile=None)
    assert h100 is ds
    # off the fused path (the CPU) nothing is relabelled, as in JAX
    assert port_setup.maybe_reorder_dataset(ds, cfg, "node", "cpu",
                                            profile=V5E) is ds


def test_forced_reorder_finetune_losses_equal_unrelabelled(monkeypatch):
    """``--reorder rcm`` through ``run_finetune`` on the layout route (the
    kernels' plain versions on the CPU): the relabel is a permutation, so
    each epoch's losses equal the unrelabelled run's to 1e-5 (dropout 0,
    the same initial model, an initted codebook)."""
    from stemgnn_tpu_torch.nn.encoder import Encoder
    from stemgnn_tpu_torch.vq.quantize import VectorQuantize
    monkeypatch.setattr(port_setup, "_layout_applies",
                        lambda cfg, device: cfg.encoder.backbone == "sage")
    d = 16
    ds = port_synthetic.synthetic_node_dataset(
        num_nodes=600, num_classes=4, feat_dim=d, num_splits=1,
        train_per_split=200, val_per_split=100, seed=5)
    base = pcfg.FinetuneConfig(
        encoder=pcfg.EncoderConfig(input_dim=d, hidden_dim=d, num_layers=2,
                                   normalize="batch", dropout=0.0),
        vq=pcfg.VQConfig(dim=d, codebook_size=8, codebook_dim=d, heads=2),
        task="node", num_classes=4, epochs=3, early_stop=100, repeat=1,
        hub_size=0)
    torch.manual_seed(0)
    enc, vq = Encoder(base.encoder), VectorQuantize(base.vq)
    vq.initted.fill_(True)
    runs = {}
    for mode in ("off", "rcm"):
        cfg = dataclasses.replace(base, reorder=mode)
        res = port_ft.run_finetune(ds, cfg, {"encoder": enc, "vq": vq},
                                   device="cpu")
        runs[mode] = res
    assert runs["rcm"]["graph"].layout is not None
    for a, b in zip(runs["off"]["epoch_losses"], runs["rcm"]["epoch_losses"]):
        for k in ("loss", "act_loss"):
            np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-5,
                                       atol=1e-6)
