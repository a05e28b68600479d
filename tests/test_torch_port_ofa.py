"""The port's OFA in-context and few-shot path (``stemgnn_tpu_torch/ofa``,
``utils/splits``) against the JAX package on the CPU.

Host side, bit-equal for the same seeds: the hop sampler and induced
edges (a star of 150 neighbours, whose with-replacement downsampling
repeats nodes), every prompt variant, ``collate_prompted``'s graph, aux
arrays and padding (the dead graph slot), the first samples of every
runtime dataset, few-shot episodes, ``MultiDataset.update`` over a
plateau, the splitters, the low-resource split, the task constructor and
``random_walk_pe``.  Device side, with JAX's initial weights carried
across: ``bin_graph_apply`` with attention pooling and RWPE (forward,
statistics, gradients), ``ofa_train_eval`` for one epoch with gine and
rgat on the single-label node task and the NaN-labelled multitask
molecules (every step's loss within 1e-4 relative, the metric equal),
and ``fewshot_train_eval`` on a 2-way 2-shot split (the same episodes,
losses within 1e-4 relative, the accuracy equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.data import synthetic as jsyn
from stemgnn_tpu.ofa import datasets as jds
from stemgnn_tpu.ofa import fewshot as jfs
from stemgnn_tpu.ofa import heads as jheads
from stemgnn_tpu.ofa import multi as jmulti
from stemgnn_tpu.ofa import prompt as jprompt
from stemgnn_tpu.ofa import subgraph as jsub
from stemgnn_tpu.ofa import tasks as jtasks
from stemgnn_tpu.ofa import train as jtrain
from stemgnn_tpu.utils import splits as jsplits
from stemgnn_tpu.zoo import mlp as jmlp
from stemgnn_tpu.zoo import stack as jstack
from stemgnn_tpu_torch.data import synthetic as psyn
from stemgnn_tpu_torch.ofa import datasets as pds
from stemgnn_tpu_torch.ofa import fewshot as pfs
from stemgnn_tpu_torch.ofa import heads as pheads
from stemgnn_tpu_torch.ofa import multi as pmulti
from stemgnn_tpu_torch.ofa import prompt as pprompt
from stemgnn_tpu_torch.ofa import subgraph as psub
from stemgnn_tpu_torch.ofa import tasks as ptasks
from stemgnn_tpu_torch.ofa import train as ptrain
from stemgnn_tpu_torch.utils import convert
from stemgnn_tpu_torch.utils import splits as psplits

D = 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def same(got, want):
    """Host values equal, bit for bit (dicts, lists and arrays)."""
    if isinstance(want, dict):
        assert set(got) == set(want), set(got) ^ set(want)
        for k in want:
            same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_array_equal(g, w)


def rel_close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=0)


def node_datasets(num_nodes=120, num_classes=4):
    kw = dict(num_nodes=num_nodes, num_classes=num_classes, feat_dim=D,
              train_per_split=20, val_per_split=30, num_splits=1, seed=0)
    jd, pd_ = jsyn.synthetic_node_dataset(**kw), \
        psyn.synthetic_node_dataset(**kw)
    same(pd_.edge_index, jd.edge_index)
    same(pd_.node_text_feat, jd.node_text_feat)
    return jd, pd_


def kg_datasets():
    kw = dict(num_entities=80, num_relations=3, num_edges=400, feat_dim=D,
              seed=0)
    jd, pd_ = jsyn.synthetic_link_dataset(**kw), \
        psyn.synthetic_link_dataset(**kw)
    same(pd_.edge_index, jd.edge_index)
    return jd, pd_


def graph_lists(num_graphs=40, num_tasks=3):
    kw = dict(num_graphs=num_graphs, num_tasks=num_tasks, feat_dim=D, seed=0)
    jg, pg = jsyn.synthetic_graph_dataset(**kw), \
        psyn.synthetic_graph_dataset(**kw)
    same(pg[1], jg[1])
    return jg, pg


# ------------------------------------------------------------ host side

def test_hop_sampler_and_induced_edges_on_a_star_with_duplicates():
    """A star of 150 leaves and a second ring: the 1-hop fringe is over
    the cap of 100 and is downsampled with replacement, so nodes repeat;
    the induced edges of the duplicated node list keep the later local
    id, in both packages."""
    leaves = np.arange(1, 151)
    ring = np.stack([leaves, np.roll(leaves, 1)])
    outer = np.stack([leaves, leaves + 150])
    ei = np.concatenate([np.stack([np.zeros(150, np.int64), leaves]), ring,
                         outer], axis=1)
    for undirected in (False, True):
        ja = jsub.CSRAdjacency(ei, 301, to_undirected=undirected)
        pa = psub.CSRAdjacency(ei, 301, to_undirected=undirected)
        same([pa.indptr, pa.dst, pa.edge_id], [ja.indptr, ja.dst, ja.edge_id])
        for roots, hop in (([0], 1), ([0], 2), ([0, 7], 2), ([299], 3)):
            jn = jsub.sample_fixed_hop_neighbors(
                ja, roots, hop, 100, np.random.default_rng(5))
            pn = psub.sample_fixed_hop_neighbors(
                pa, roots, hop, 100, np.random.default_rng(5))
            same(pn, jn)
            nodes = np.r_[np.asarray(roots), pn]
            same(psub.induced_edges(pa, nodes), jsub.induced_edges(ja, nodes))
    nbrs = psub.sample_fixed_hop_neighbors(
        psub.CSRAdjacency(ei, 301), [0], 1, 100, np.random.default_rng(5))
    assert len(nbrs) == 100 and len(np.unique(nbrs)) < 100


def _prompt_inputs(seed=0, n=7, c=3, nan=False):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((n, D)).astype(np.float32)
    ei = rng.integers(0, n, (2, 12))
    ef = rng.standard_normal((12, D)).astype(np.float32)
    class_emb = rng.standard_normal((c, D)).astype(np.float32)
    pe = rng.standard_normal((5, D)).astype(np.float32)
    rep = np.zeros(c, np.float32)
    rep[1] = 1.0
    if nan:
        rep[2] = np.nan
    return feat, ei, ef, class_emb, pe, rep


@pytest.mark.parametrize("variant", [
    "flat", "hier", "hier_no_class", "flat_no_class", "hier_all_targets",
    "nan_labels", "custom_edges"])
def test_every_prompt_variant_is_bit_equal(variant):
    feat, ei, ef, class_emb, pe, rep = _prompt_inputs(
        nan=variant == "nan_labels")
    kw = {}
    if variant.startswith("hier") or variant in ("nan_labels",
                                                 "custom_edges"):
        kw["noi_node_emb"] = pe[:1]
    if variant.endswith("no_class"):
        kw["no_class_node"] = True
    if variant == "hier_all_targets":
        kw["hier_targets_are_all_nodes"] = True
    if variant == "custom_edges":
        kw["prompt_edge_list"] = {"f2n": (1, 2), "n2c": (5, 4),
                                  "c2n": (4, 0)}
    args = (feat, ei, ef, [0, 2], class_emb, pe, rep)
    same(pprompt.build_prompted_graph(*args, **kw),
         jprompt.build_prompted_graph(*args, **kw))


def test_collate_prompted_graph_aux_and_padding():
    """Three prompted graphs padded to 64 nodes and 128 edges: the graph
    (padded nodes on the dead slot 3), the aux arrays and their padding."""
    samples = []
    for i in range(3):
        feat, ei, ef, class_emb, pe, rep = _prompt_inputs(seed=i, n=5 + i,
                                                          nan=i == 1)
        samples.append(jprompt.build_prompted_graph(
            feat, ei, ef, [0], class_emb, pe, rep, noi_node_emb=pe[:1]))
    jg, jaux = jprompt.collate_prompted(samples, node_pad_to=64,
                                        edge_pad_to=128)
    pg, paux = pprompt.collate_prompted(samples, node_pad_to=64,
                                        edge_pad_to=128)
    same(paux, jaux)
    for k in ("node_feat", "senders", "receivers", "node_mask", "edge_mask",
              "edge_feat", "node_graph_id"):
        same(getattr(pg, k).numpy(), np.asarray(getattr(jg, k)))
    assert pg.n_graph == int(jg.n_graph) == 3
    assert (pg.node_graph_id[pg.n_node:] == 3).all()


def _first(ds, count=4):
    return [ds[i] for i in range(count)]


@pytest.mark.parametrize("hier,undirected", [(True, False), (False, True)])
def test_subgraph_node_dataset_first_samples(hier, undirected):
    jd, pd_ = node_datasets()
    class_emb = np.eye(4, D, dtype=np.float32)
    pe = np.ones((5, D), np.float32)
    kw = dict(data_idx=np.arange(20, 40), hier=hier,
              to_undirected=undirected, max_nodes_per_hop=6, seed=3)
    same(_first(pds.SubgraphNodeDataset(pd_, class_emb, pe, **kw)),
         _first(jds.SubgraphNodeDataset(jd, class_emb, pe, **kw)))


def test_link_and_kg_datasets_first_samples():
    """The link dataset's rejection-sampled negatives and removed target
    edges; the KG dataset's inverse-relation edges, with and without the
    removed triple."""
    jd, pd_ = node_datasets()
    class_emb = np.eye(2, D, dtype=np.float32)
    pe = np.ones((5, D), np.float32)
    pos = np.asarray(jd.edge_index).T[:10]
    kw = dict(remove_edge=True, max_nodes_per_hop=8, seed=2)
    pl = pds.SubgraphLinkHierDataset(pd_, class_emb, pe, pos, **kw)
    jl = jds.SubgraphLinkHierDataset(jd, class_emb, pe, pos, **kw)
    same(pl.neg_edges, jl.neg_edges)
    same([pl[i] for i in (0, 1, 12, 15)], [jl[i] for i in (0, 1, 12, 15)])
    jk, pk = kg_datasets()
    pairs = np.asarray(jk.edge_index).T[:12]
    types = np.asarray(jk.labels)[:12]
    for remove in (False, True):
        kw = dict(remove_edge=remove, max_nodes_per_hop=10, seed=1)
        same(_first(pds.SubgraphKGHierDataset(pk, np.eye(3, D), pe, pairs,
                                              types, **kw)),
             _first(jds.SubgraphKGHierDataset(jk, np.eye(3, D), pe, pairs,
                                              types, **kw)))


def test_graph_list_dataset_first_samples_with_nan_labels():
    (jgr, jlab, _), (pgr, plab, _) = graph_lists()
    assert np.isnan(plab).any()
    class_emb = np.eye(3, D, dtype=np.float32)
    pe = np.ones((5, D), np.float32)
    for no_class in (False, True):
        got = _first(pds.GraphListHierDataset(pgr, plab, class_emb, pe,
                                              np.arange(8, 20),
                                              no_class_node=no_class), 6)
        want = _first(jds.GraphListHierDataset(jgr, jlab, class_emb, pe,
                                               np.arange(8, 20),
                                               no_class_node=no_class), 6)
        same(got, want)


@pytest.mark.parametrize("min_shot", [None, 1])
def test_fewshot_episodes(min_shot):
    jd, pd_ = node_datasets()
    class_emb = np.eye(4, D, dtype=np.float32)
    pe = np.ones((5, D), np.float32)
    labels = np.asarray(jd.labels)
    data_ind = [np.where(labels == c)[0] for c in range(4)]
    out = []
    for ds_mod, fs_mod, ds in ((jds, jfs, jd), (pds, pfs, pd_)):
        base = ds_mod.SubgraphNodeDataset(ds, class_emb, pe,
                                          data_idx=np.arange(120),
                                          max_nodes_per_hop=5, seed=4)
        fs = fs_mod.SimpleFSManager(np.arange(4), data_ind, k_shot=3,
                                    q_query=1, n_way=3,
                                    min_k_shot=min_shot,
                                    min_n_way=None if min_shot is None
                                    else 2, seed=7)
        fsd = fs_mod.FewShotDataset(fs, base, base,
                                    fs_edge_feats=np.ones((2, D)),
                                    sample_size=3, seed=8)
        out.append([fsd[i] for i in range(3)])
    same(out[1], out[0])


def test_multidataset_update_over_a_plateau():
    """Two datasets, one improving and one flat: the flat one's multiple
    halves down to the floor, with the same sizes and draws as JAX's."""
    class Fake:
        def __init__(self, n, tag):
            self.n, self.tag = n, tag

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            return (self.tag, i)
    metrics = [[0.5 + 0.05 * e, 0.7] for e in range(12)]
    runs = []
    for mod in (jmulti, pmulti):
        md = mod.MultiDataset([Fake(30, "a"), Fake(20, "b")],
                              dataset_multiple=[1.0, 2.0], window_size=2,
                              patience=1, min_ratio=0.25,
                              mode=["max", "max"], seed=3)
        trace = []
        for m in metrics:
            md.update(m)
            trace.append([md.dataset_multiple.copy(), md.aug_sizes.copy(),
                          md.sample_ind.copy(), md.inpatience.copy(),
                          [md[i] for i in range(0, len(md), 7)]])
        runs.append(trace)
    same(runs[1], runs[0])
    assert runs[1][-1][0][1] == 0.25 and runs[1][-1][0][0] == 1.0


def test_splitters_low_resource_split_and_task_constructor():
    jd, pd_ = node_datasets(num_nodes=200)
    same(ptasks.arxiv_splitter(pd_), jtasks.arxiv_splitter(jd))
    same(ptasks.cite_splitter(pd_), jtasks.cite_splitter(jd))
    jk, pk = kg_datasets()
    same(ptasks.cite_link_splitter(pk, seed=4),
         jtasks.cite_link_splitter(jk, seed=4))
    same(ptasks.kg_splitter(pk), jtasks.kg_splitter(jk))
    jk.extras["split_counts"] = pk.extras["split_counts"] = [300, 50, 50]
    same(ptasks.kg_splitter(pk), jtasks.kg_splitter(jk))
    same(ptasks.kg_fs_splitter(pk), jtasks.kg_fs_splitter(jk))
    for name in ("arxiv", "FB15K237"):
        same(ptasks.low_resource_class_split(name),
             jtasks.low_resource_class_split(name))
    with pytest.raises(KeyError):
        ptasks.low_resource_class_split("cora")
    split = {"train": [0, 2], "valid": [1], "test": [3]}
    same(ptasks.fs_splitter(pd_, split), jtasks.fs_splitter(jd, split))
    same(ptasks.fs_splitter(pd_), jtasks.fs_splitter(jd))
    labels = np.random.default_rng(0).integers(0, 5, 90)
    same(psplits.k_fold_ind(labels, 4, seed=2),
         jsplits.k_fold_ind(labels, 4, seed=2))
    folds = jsplits.k_fold_ind(labels, 4)
    same(psplits.k_fold2_split(folds, 90), jsplits.k_fold2_split(folds, 90))
    same(psplits.random_split_masks(77, 0.2, 0.3, seed=5),
         jsplits.random_split_masks(77, 0.2, 0.3, seed=5))
    jt = jtasks.TaskConstructor(feat_dim=D, seed=1)
    pt = ptasks.TaskConstructor(feat_dim=D, seed=1)
    same(_first(pt.make_subgraph_dataset("cora_synthetic", "valid"), 2),
         _first(jt.make_subgraph_dataset("cora_synthetic", "valid"), 2))
    same(_first(pt.make_link_dataset("kg_synthetic", "test"), 2),
         _first(jt.make_link_dataset("kg_synthetic", "test"), 2))


def test_random_walk_pe_is_bit_equal():
    rng = np.random.default_rng(0)
    s, r = rng.integers(0, 30, 90), rng.integers(0, 30, 90)
    em = rng.random(90) > 0.2
    for mask in (None, em):
        same(pheads.random_walk_pe(s, r, 32, 6, edge_mask=mask),
             jheads.random_walk_pe(s, r, 32, 6, edge_mask=mask))


# ------------------------------------------------------------ device side

def _prompted_batch(seed=0):
    jd, pd_ = node_datasets()
    class_emb = np.eye(4, D, dtype=np.float32)
    pe = np.ones((5, D), np.float32)
    ds = jds.SubgraphNodeDataset(jd, class_emb, pe, data_idx=np.arange(6),
                                 max_nodes_per_hop=6, seed=seed)
    samples = _first(ds, 6)
    tot_n = sum(len(s["node_feat"]) for s in samples)
    return samples, tot_n


@pytest.mark.parametrize("kind", ["gine", "rgat"])
def test_bin_graph_head_with_att_pool_and_rwpe(kind):
    """``bin_graph_apply`` with attention pooling and RWPE, training then
    evaluation: scores, the stack's and the PE's BatchNorm statistics,
    and every gradient (none reaches the PE's BatchNorm)."""
    samples, tot_n = _prompted_batch()
    jg, aux = jprompt.collate_prompted(samples, node_pad_to=tot_n + 9,
                                       edge_pad_to=256)
    pg, _ = pprompt.collate_prompted(samples, node_pad_to=tot_n + 9,
                                     edge_pad_to=256)
    wl = 8                                    # D + wl divisible by 8 heads
    pe = np.concatenate([jheads.random_walk_pe(
        s["senders"], s["receivers"], len(s["node_feat"]), wl)
        for s in samples])
    rwpe = np.zeros((tot_n + 9, wl), np.float32)
    rwpe[:tot_n] = pe
    params, state = jheads.bin_graph_init(jax.random.PRNGKey(1), kind, 2, D,
                                          D, att_pool=True, walk_length=wl)
    tm = aux["true_nodes_mask"]
    lab = aux["bin_labels"]

    def f(p):
        s, ns = jheads.bin_graph_apply(p, state, kind, jg, aux,
                                       training=True, rwpe=jnp.asarray(rwpe))
        return jnp.sum(jnp.where(tm, s * lab, 0.0)), (s, ns)
    (_, (want, ns)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    head = convert.bin_graph_from_jax(_np(params), _np(state)).train()
    got = pheads.bin_graph_apply(head, pg, aux, rwpe=torch.from_numpy(rwpe))
    np.testing.assert_array_equal(np.isinf(got.detach().numpy()),
                                  np.isinf(np.asarray(want)))
    rel_close(got.detach().numpy()[tm], np.asarray(want)[tm], rel=1e-5)
    torch.where(torch.from_numpy(tm), got * torch.from_numpy(lab),
                torch.zeros(())).sum().backward()
    wg = {k: np.asarray(v) for k, v in
          convert._flat_names(_np(grads)).items()}
    top = max(float(np.abs(v).max()) for v in wg.values())
    for n, p in head.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(g, wg[n], rtol=0, atol=1e-4 * top,
                                   err_msg=n)
    assert head.rwpe_norm.scale.grad is None
    for k, v in convert._flat_names(_np(ns)).items():
        np.testing.assert_allclose(dict(head.named_buffers())[k].numpy(), v,
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    want_eval, _ = jheads.bin_graph_apply(params, ns, kind, jg, aux,
                                          training=False,
                                          rwpe=jnp.asarray(rwpe))
    with torch.no_grad():
        got_eval = pheads.bin_graph_apply(head.eval(), pg, aux,
                                          rwpe=torch.from_numpy(rwpe))
    rel_close(got_eval.numpy()[tm], np.asarray(want_eval)[tm], rel=1e-5)


def _jax_step_losses(monkeypatch):
    """Every training step's loss of JAX's ``ofa_train_eval``: its jitted
    ``train_step`` wrapped while it runs."""
    losses = []
    real_jit = jax.jit

    def spy(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") != "train_step":
            return jitted

        def step(*args):
            out = jitted(*args)
            losses.append(float(out[-1]))
            return out
        return step
    monkeypatch.setattr(jtrain.jax, "jit", spy)
    return losses


def _jax_initial_model(kind, num_layers, dim, seed):
    """The weights JAX's ``ofa_train_eval`` draws for ``seed``, as the
    port's :class:`OFAModel`."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    enc_p, enc_s = jstack.gnn_stack_init(k1, kind, num_layers, dim)
    head_p, head_s = jmlp.mlp_init(k2, [dim, 2 * dim, 1], batch_norm=False)
    return convert.ofa_model_from_jax(_np({"enc": enc_p, "head": head_p}),
                                      _np({"enc": enc_s, "head": head_s}))


@pytest.mark.parametrize("kind,task", [("gine", "single"),
                                       ("rgat", "single"),
                                       ("gine", "multi")])
def test_ofa_train_eval_matches_jax(kind, task, monkeypatch):
    """One epoch of 3 batches with JAX's initial weights: every step's
    loss within 1e-4 relative, the final loss and the metric equal (the
    node task's accuracy; the molecules' nan-tolerant mean AUC over NaN
    labels)."""
    if task == "single":
        jd, pd_ = node_datasets()
        class_emb = np.eye(4, D, dtype=np.float32)
        pe = np.ones((5, D), np.float32)
        kw = dict(data_idx=np.arange(60), max_nodes_per_hop=8, seed=2)
        jdata = jds.SubgraphNodeDataset(jd, class_emb, pe, **kw)
        pdata = pds.SubgraphNodeDataset(pd_, class_emb, pe, **kw)
    else:
        (jgr, jlab, _), (pgr, plab, _) = graph_lists(num_graphs=60)
        class_emb = np.eye(3, D, dtype=np.float32)
        pe = np.ones((5, D), np.float32)
        jdata = jds.GraphListHierDataset(jgr, jlab, class_emb, pe,
                                         np.arange(60))
        pdata = pds.GraphListHierDataset(pgr, plab, class_emb, pe,
                                         np.arange(60))
    tr, ev = np.arange(0, 24), np.arange(24, 60)
    # the default lr (1e-3): AdamW turns the rounding-level gradients of
    # the biases under a BatchNorm into lr-sized steps either way, which
    # part the two packages' trained weights by ~lr there
    kw = dict(dim=D, kind=kind, num_layers=2, epochs=1, batch_size=8,
              seed=3, task=task)
    losses = _jax_step_losses(monkeypatch)
    jloss, jmetric = jtrain.ofa_train_eval(jdata, tr, ev, **kw)
    stats = {}
    ploss, pmetric = ptrain.ofa_train_eval(
        pdata, tr, ev, **kw, device="cpu", stats=stats,
        model=_jax_initial_model(kind, 2, D, 3))
    assert len(losses) == 3
    rel_close(stats["losses"], losses)
    rel_close(ploss, jloss)
    assert pmetric == jmetric and 0.0 <= pmetric <= 1.0
    assert len(stats["host_ms"]) == 3 and len(stats["step_ms"]) == 3
    assert len(stats["eval_ms"]) == 5


def test_fewshot_train_eval_matches_jax(monkeypatch):
    """2-way 2-shot, one epoch, a model per held-out split as JAX trains
    it: the episodes drawn the same, every step's loss within 1e-4
    relative, each split's accuracy equal."""
    jd, pd_ = node_datasets()
    class_emb = np.eye(4, D, dtype=np.float32)
    pe = np.ones((5, D), np.float32)
    kw = dict(data_idx=np.arange(120), max_nodes_per_hop=4, seed=1)
    jbase = jds.SubgraphNodeDataset(jd, class_emb, pe, **kw)
    pbase = pds.SubgraphNodeDataset(pd_, class_emb, pe, **kw)
    labels = np.asarray(jd.labels)
    split = {"train": [0, 1], "valid": [2, 3], "test": [3, 0]}
    fkw = dict(dim=D, n_way=2, k_shot=2, train_episodes=8, eval_episodes=4,
               epochs=1, batch_size=4, seed=5)
    losses = _jax_step_losses(monkeypatch)
    want = jtrain.fewshot_train_eval(jbase, labels, split, **fkw)
    stats = {}
    got = ptrain.fewshot_train_eval(pbase, labels, split, **fkw,
                                    device="cpu", stats=stats,
                                    model=_jax_initial_model("gine", 2, D, 5))
    assert set(got) == set(want) == {"train_loss", "valid_acc", "test_acc"}
    assert len(losses) == 4
    rel_close(stats["valid"]["losses"] + stats["test"]["losses"], losses)
    rel_close(got["train_loss"], want["train_loss"])
    assert got["valid_acc"] == want["valid_acc"]
    assert got["test_acc"] == want["test_acc"]


def test_ofa_train_eval_seeds_its_own_model_on_the_cpu():
    """Without an initial model the port draws its own from the seed: two
    runs agree, and the losses are finite."""
    _, pd_ = node_datasets()
    data = pds.SubgraphNodeDataset(pd_, np.eye(4, D, dtype=np.float32),
                                   np.ones((5, D), np.float32),
                                   data_idx=np.arange(20),
                                   max_nodes_per_hop=4, seed=0)
    runs = []
    for _ in range(2):
        stats = {}
        data.rng = np.random.default_rng(0)
        runs.append((ptrain.ofa_train_eval(
            data, np.arange(12), np.arange(12, 20), dim=D, kind="rgcn",
            epochs=1, batch_size=4, device="cpu", stats=stats),
            stats["losses"]))
    assert runs[0] == runs[1]
    assert np.isfinite(runs[0][1]).all()
