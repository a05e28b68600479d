"""The port's minibatch pretrain against the JAX package on the CPU: the
neighbour sampler (numpy and native paths), ``merge_datasets`` and
``materialize_graph``, one minibatch step on both routes, ``run_pretrain``
over two epochs, the k-means init of the codebook (pretrain and finetune),
the checkpoints JAX reads, the resume, the schedule's horizon and the
pretrain CLI.

JAX and torch cannot share random draws: the step tests draw them with
``jax.random`` exactly as JAX's step does and hand them to the port's, with
the encoders' dropout at 0; the k-means tests hand the port JAX's initial
means.  The sampler's draws come from numpy generators on both sides and
must be equal bit for bit.
"""

import copy
import importlib.util
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.core.graph import make_indexed_graph as jax_make_indexed
from stemgnn_tpu.core.graph import materialize_graph as jax_materialize
from stemgnn_tpu.data import sampler as jax_sampler
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.data.merge import merge_datasets as jax_merge
from stemgnn_tpu.models import pretrain as jax_pre
from stemgnn_tpu.models import task as jax_task
from stemgnn_tpu.nn.encoder import encoder_apply
from stemgnn_tpu.train import augment as jax_augment
from stemgnn_tpu.train import pretrain_loop as jax_loop
from stemgnn_tpu.train.optim import make_optimizer as jax_optimizer
from stemgnn_tpu.utils import checkpoint as jax_ckpt
from stemgnn_tpu.vq import codebook as jax_cb
from stemgnn_tpu.vq import quantize as jax_vq
from stemgnn_tpu_torch import pretrain as port_cli
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.core.graph import (indexed_to_device,
                                          materialize_graph)
from stemgnn_tpu_torch.data import native_sampler
from stemgnn_tpu_torch.data import sampler as port_sampler
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.data.merge import merge_datasets as port_merge
from stemgnn_tpu_torch.models import task as port_task
from stemgnn_tpu_torch.models.pretrain import PretrainModel, make_teacher
from stemgnn_tpu_torch.ops import fused_sage as port_fused_mod
from stemgnn_tpu_torch.train import finetune_loop as port_ft
from stemgnn_tpu_torch.train import pretrain_loop as port_loop
from stemgnn_tpu_torch.utils import checkpoint as port_ckpt
from stemgnn_tpu_torch.utils.convert import (_load, pretrain_from_jax,
                                             pretrain_to_jax,
                                             task_model_from_jax)
from stemgnn_tpu_torch.vq import codebook as port_cb
from stemgnn_tpu_torch.vq.quantize import VectorQuantize, vq_kmeans_init

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32
BS = 128


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------- sampler

def _random_graph(n=600, e=5000, hot=False):
    rng = np.random.default_rng(7)
    dst = rng.integers(0, 40 if hot else n, e)
    ei = np.stack([rng.integers(0, n, e), dst])
    return ei, rng.integers(0, 3, e)


# (fanouts, explicit pads): auto buckets; pads too small (escalations);
# an unbounded hop over hub in-edges (truncations at the closure caps)
SAMPLER_CASES = {"auto": ([5, 5], None, False),
                 "escalate": ([5, 5], (128, 128), False),
                 "truncate": ([-1], None, True)}


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sampler_batches_equal_jax(native, case):
    """The same numpy seeds give the same batches: node ids, local edges,
    edge types, masks, global node ids, the padding buckets, escalations
    and truncations; on the native path the port's own build of its copy
    of the source against JAX's committed library, and the raw edge ids
    of ``sample_subgraph(_native)``."""
    from stemgnn_tpu.data import native_sampler as jax_native
    if native:
        assert jax_native.native_available()
    fanouts, pads, hot = SAMPLER_CASES[case]
    ei, xe = _random_graph(hot=hot)
    n = 600
    seeds = port_sampler.get_train_node_idx(np.array([0, 400, 600]),
                                            [1.5, 2.0],
                                            np.random.default_rng(1))
    assert np.array_equal(seeds, jax_sampler.get_train_node_idx(
        np.array([0, 400, 600]), [1.5, 2.0], np.random.default_rng(1)))
    kw = dict(drop_last=True, use_native=native)
    if pads is not None:
        kw.update(node_pad=pads[0], edge_pad=pads[1])
    its = [jax_sampler.NeighborBatchIterator(
        jax_sampler.CSCGraph.from_edge_index(ei, n), None, None,
        np.arange(n), xe, seeds, 64, fanouts, np.random.default_rng(5),
        indexed=True, **kw),
        port_sampler.NeighborBatchIterator(
        port_sampler.CSCGraph.from_edge_index(ei, n), np.arange(n), xe,
        seeds, 64, fanouts, np.random.default_rng(5), **kw)]
    assert its[1]._native == native
    assert (its[0].node_pad, its[0].edge_pad) == (its[1].node_pad,
                                                  its[1].edge_pad)
    count = 0
    for (gj, sj, nj), (gp, sp, np_) in zip(*its):
        for f in ("node_ids", "senders", "receivers", "node_mask",
                  "edge_mask", "xe_ids"):
            assert np.array_equal(np.asarray(getattr(gj, f)),
                                  getattr(gp, f)), f
        assert (int(gj.n_node), int(gj.n_edge)) == (gp.n_node, gp.n_edge)
        assert sj == sp and np.array_equal(nj, np_)
        count += 1
    assert count == len(its[1]) == len(seeds) // 64
    for attr in ("node_pad", "edge_pad", "escalations", "truncations"):
        assert getattr(its[0], attr) == getattr(its[1], attr), attr
    if case == "escalate":
        assert its[1].escalations > 0
    if case == "truncate":
        assert its[1].truncations > 0
    # the raw samples, edge ids included
    csc = port_sampler.CSCGraph.from_edge_index(ei, n)
    chunk = seeds[:64]
    if native:
        want = jax_native.sample_subgraph_native(csc, chunk, fanouts, 99)
        got = native_sampler.sample_subgraph_native(csc, chunk, fanouts, 99)
    else:
        want = jax_sampler.sample_subgraph(csc, chunk, fanouts,
                                           np.random.default_rng(3))
        got = port_sampler.sample_subgraph(csc, chunk, fanouts,
                                           np.random.default_rng(3))
    for a, b in zip(want, got):
        assert np.array_equal(a, b)


def _merged(pkg, merge):
    return merge([
        pkg.synthetic_node_dataset(num_nodes=300, num_classes=4, feat_dim=16,
                                   num_splits=1, seed=2),
        pkg.synthetic_link_dataset(num_entities=200, num_edges=800,
                                   feat_dim=16, seed=2)])


def test_merge_and_materialize_equal_jax():
    """``merge_datasets`` over cora_synthetic + kg_synthetic equals JAX's,
    and a sampled batch materialized from the resident tables equals JAX's
    ``materialize_graph`` (padded rows zeroed)."""
    mj = _merged(jax_synthetic, jax_merge)
    mp = _merged(port_synthetic, port_merge)
    assert set(mj) == set(mp)
    for k in mj:
        if k == "names":
            assert mj[k] == mp[k]
        else:
            assert np.array_equal(np.asarray(mj[k]), mp[k]), k
    assert list(mp["ptr"]) == [0, 300, 500]
    assert mp["edge_text_feat"].shape[0] == 12
    csc = port_sampler.CSCGraph.from_edge_index(mp["edge_index"], 500)
    it = port_sampler.NeighborBatchIterator(
        csc, mp["x"], mp["xe"], np.arange(500), 64, [5, 5],
        np.random.default_rng(0))
    ig = next(iter(it))[0]
    assert ig.n_node < ig.num_nodes_padded and ig.n_edge < \
        ig.num_edges_padded
    ig_j = jax_sampler.NeighborBatchIterator(
        jax_sampler.CSCGraph.from_edge_index(mp["edge_index"], 500), None,
        None, mp["x"], mp["xe"], np.arange(500), 64, [5, 5],
        np.random.default_rng(0), indexed=True)
    gj = jax_materialize(next(iter(ig_j))[0],
                         jnp.asarray(mj["node_text_feat"]),
                         jnp.asarray(mj["edge_text_feat"]))
    gp = materialize_graph(indexed_to_device(ig, "cpu"), torch.from_numpy(mp["node_text_feat"]),
                           torch.from_numpy(mp["edge_text_feat"]))
    for f in ("node_feat", "edge_feat", "senders", "receivers", "node_mask",
              "edge_mask"):
        assert np.array_equal(np.asarray(getattr(gj, f)),
                              getattr(gp, f).numpy()), f
    assert not gp.node_feat[ig.n_node:].any()
    assert not gp.edge_feat[ig.n_edge:].any()


# ------------------------------------------------------------- the step

def _node_ds(pkg, n=400):
    return pkg.synthetic_node_dataset(num_nodes=n, num_classes=5,
                                      feat_dim=D, avg_degree=6,
                                      pref_attach=1.1, num_splits=1, seed=3)


def _jax_cfg(**kw):
    return jcfg.PretrainConfig(
        encoder=jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="batch", dropout=0.0),
        vq=jcfg.VQConfig(dim=D, codebook_size=16, codebook_dim=D, heads=4),
        batch_size=BS, fanout=5, **kw)


def _port_cfg(cfg, **kw):
    d = {k: v for k, v in dataclasses.asdict(cfg).items()
         if k not in ("encoder", "vq")}
    d.update(kw)
    return pcfg.PretrainConfig(encoder=pcfg.EncoderConfig(
        **dataclasses.asdict(cfg.encoder)), vq=pcfg.VQConfig(
        **dataclasses.asdict(cfg.vq)), **d)


def _jax_draws(cfg, g, rng):
    """The draws JAX's step makes from ``rng`` (pretrain_loop.py:64-67,
    models/pretrain.py:113, 138-148, vq/quantize.py:197, 138), for a graph
    with ``num_edges_padded``, ``edge_mask``, ``n_node`` and
    ``num_nodes_padded``."""
    k_feat, k_edge, k_fwd = jax.random.split(rng, 3)
    _, k_vq, k_topo, k_neg, _, _ = jax.random.split(k_fwd, 6)
    num = max(int(g.num_edges_padded * cfg.topo_recon_ratio), 1)
    slots, _ = jax_pre._sample_edge_slots(k_topo, jnp.asarray(
        np.asarray(g.edge_mask)), num)
    neg = jax_pre._negative_edges(k_neg, num, int(g.n_node),
                                  g.num_nodes_padded)
    _, k_ortho, _ = jax.random.split(k_vq, 3)
    keep = jax.random.bernoulli(k_feat, 1.0 - cfg.feat_p, (D,))
    t = lambda a: torch.from_numpy(np.array(a)).long()  # noqa: E731
    return dict(
        feat_keep=torch.from_numpy(np.array(keep)),
        drop_seed=t(jax_augment.dropout_edge_seed(k_edge)),
        slots=t(slots), neg=(t(neg[0]), t(neg[1])),
        ortho_ids=t(jax.random.permutation(
            k_ortho, cfg.vq.codebook_size)[:cfg.vq.orthogonal_reg_max_codes]))


def _jax_init(cfg):
    """JAX ``run_pretrain``'s initial trees and its key after the init
    split."""
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init = jax.random.split(key)
    trees = tuple(_np(t) for t in jax_pre.pretrain_init(k_init, cfg))
    return trees, key, k_init


def _capture():
    """An optax transformation that passes the updates on and keeps them in
    its state: chained first, the step's gradients before the optimizer."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _grad_tree(model, teacher):
    """The student's gradients as the step left them (clipped) in JAX's
    parameter tree."""
    gm = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(gm.parameters(), model.parameters()):
            p.copy_(q.grad)
    return pretrain_to_jax(gm, teacher)[0]


def _tables(merged):
    return (torch.from_numpy(np.asarray(merged["node_text_feat"],
                                        np.float32)),
            torch.from_numpy(np.asarray(merged["edge_text_feat"],
                                        np.float32)))


@pytest.mark.parametrize("route", ["auto", "on"])
def test_minibatch_step_matches_jax(route, monkeypatch):
    """One step on a sampled batch against JAX's ``make_pretrain_step(...,
    indexed=True)`` + optax, the same converted weights and JAX's draws.
    ``auto``: the gather + index_add_ path, JAX's arithmetic: losses and
    parameters to 1e-5.  ``on``: the batch's own layout (no hubs; kernel 1's
    plain version on the student's three dropout tails, kernel 2's on the
    teacher's two), bf16 messages: the bf16 tolerances of the full-graph
    layout test, 3e-2 for the losses and 2.1 * lr for the parameters.  On
    both routes the SAGE biases ``lin_l.b`` get 2.1 * lr (BatchNorm
    subtracts their mean, so their gradient is rounding noise).

    AdamW's first step moves a parameter by about lr * sign(g), so the
    parameters alone would pass a wrong gradient: the step's gradients
    (before AdamW, after the clip) are also held against JAX's, captured by
    an optax transformation chained in front of JAX's optimizer.  Each
    leaf's largest error is bounded relative to the step's largest
    gradient, and its error's norm relative to the leaf's norm (``lin_l.b``
    only the first).  ``auto``: 1e-5 and 1e-5 (measured 1.1e-7 and
    7.3e-7).  ``on``: 1e-2 (measured 3.9e-3), and 2e-2 on the encoder,
    whose gradients kernel 1's backward feeds (measured 6.6e-3; kernel 1's
    backward sums scaled by 1.1 give 4.5e-2 to 9.8e-2 on layer 1), 1e-1 on
    the decoders, the projector and the VQ, whose gradients near-cancel
    and so magnify the bf16 messages' rounding of the embeddings (measured
    4.1e-2)."""
    calls = {"gathered": 0, "scatter": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    for name in calls:
        attr = ("gathered_scatter_rows_sorted" if name == "gathered"
                else "scatter_rows_sorted")
        monkeypatch.setattr(port_fused_mod, attr,
                            counting(name, getattr(port_fused_mod, attr)))
    cfg = _jax_cfg()
    (params, teacher, state), _, _ = _jax_init(cfg)
    noise = np.random.default_rng(1)
    teacher = jax.tree_util.tree_map(
        lambda a: (a + noise.normal(0.0, 0.1, a.shape)).astype(a.dtype),
        teacher)
    merged = port_merge([_node_ds(port_synthetic)])
    csc = port_sampler.CSCGraph.from_edge_index(merged["edge_index"], 400)
    it = port_sampler.NeighborBatchIterator(
        csc, merged["x"], merged["xe"], np.arange(400), BS, [5, 5],
        np.random.default_rng(0), drop_last=True)
    ig = next(iter(it))[0]
    node_table, edge_table = _tables(merged)

    tx = optax.chain(_capture(), jax_optimizer(
        cfg.lr, cfg.weight_decay, grad_clip=cfg.grad_clip,
        use_scheduler=cfg.use_scheduler, epochs=cfg.epochs,
        steps_per_epoch=1))
    rng = jax.random.PRNGKey(5)
    step_j = jax_loop.make_pretrain_step(cfg, tx, bs=BS, indexed=True)
    ig_j = jax_make_indexed(
        ig.node_ids[:ig.n_node], ig.senders[:ig.n_edge],
        ig.receivers[:ig.n_edge], xe_ids=ig.xe_ids[:ig.n_edge],
        node_pad_to=ig.num_nodes_padded, edge_pad_to=ig.num_edges_padded)
    p_j, t_j, o_j, s_j, m_j = step_j(
        params, teacher, tx.init(params), state, ig_j, rng,
        jnp.asarray(node_table.numpy()), jnp.asarray(edge_table.numpy()))
    draws = _jax_draws(cfg, ig, rng)

    pc = _port_cfg(cfg, fused_minibatch=route)
    model, teach = pretrain_from_jax(params, teacher, state, pc)
    graph = port_loop.batch_graph(ig, node_table, edge_table, "cpu",
                                  port_loop.batch_layouts_on(pc))
    assert (graph.layout is not None) == (route == "on")
    if route == "on":
        assert graph.layout.hub_r is None and graph.layout.use_gwin_r
    step = port_loop.make_pretrain_step(pc, bs=BS)
    got = step(model, teach, port_loop.make_pretrain_optimizer(model, pc),
               graph, draws)
    assert calls == ({"gathered": 2, "scatter": 3} if route == "on"
                     else {"gathered": 0, "scatter": 0})
    p_p, t_p, s_p = pretrain_to_jax(model, teach)

    f32 = route == "auto"
    tol = dict(rtol=1e-5, atol=1e-5) if f32 else dict(rtol=3e-2, atol=3e-2)

    # the gradients before AdamW, both clipped as the step clips them
    g_j = o_j[0]
    if cfg.grad_clip:
        g_j = optax.clip_by_global_norm(cfg.grad_clip).update(
            g_j, optax.EmptyState())[0]
    lg, lj = _leaves(_grad_tree(model, teach)), _leaves(_np(g_j))
    assert set(lg) == set(lj)
    top = max(float(np.abs(v).max()) for v in lj.values())
    for path, leaf in lj.items():
        err = float(np.abs(lg[path] - leaf).max())
        assert err <= (1e-5 if f32 else 1e-2) * top, (path, err, top)
        if "lin_l" in path and "'b'" in path:
            continue
        rel = np.linalg.norm(lg[path] - leaf) / np.linalg.norm(leaf)
        assert rel <= (1e-5 if f32 else 2e-2 if "encoder" in path
                       else 1e-1), (path, rel)

    sign_tol = dict(rtol=0, atol=2.1 * cfg.lr)
    assert float(m_j["topo_sem_recon_loss"]) > 0
    for k, v in m_j.items():
        np.testing.assert_allclose(float(got[k]), float(v), err_msg=k, **tol)
    for tree_p, tree_j in ((p_p, _np(p_j)), (t_p, _np(t_j))):
        lp, lj = _leaves(tree_p), _leaves(tree_j)
        assert set(lp) == set(lj)
        for path, leaf in lj.items():
            noisy = "lin_l" in path and "'b'" in path
            np.testing.assert_allclose(
                lp[path], leaf, err_msg=path,
                **(tol if f32 and not noisy else sign_tol))


def test_run_pretrain_matches_jax():
    """``run_pretrain`` for 2 epochs x 3 steps (400 seeds, batches of 128,
    ``drop_last``) against JAX's, from JAX's initial weights with each
    step's draws taken from JAX's key sequence: the mean losses of each
    epoch to 1e-5 (measured: 2.0e-5 absolute on a total of 318, 6e-8
    relative) and every parameter and the teacher after the loop to 1e-4
    (measured: 3.2e-5)."""
    cfg = _jax_cfg(epochs=2)
    pj, tj, _, hj = jax_loop.run_pretrain(jax_merge([_node_ds(
        jax_synthetic)]), cfg, weights=[1.0], verbose=False)
    (params, teacher, state), key, _ = _jax_init(cfg)
    pc = _port_cfg(cfg)
    model, teach = pretrain_from_jax(params, teacher, state, pc)
    keys = {"key": key}

    def draw_fn(g):
        keys["key"], k = jax.random.split(keys["key"])
        return _jax_draws(cfg, g, k)
    model, teach, hp = port_loop.run_pretrain(
        port_merge([_node_ds(port_synthetic)]), pc, weights=[1.0],
        device="cpu", model=model, teacher=teach, draw_fn=draw_fn,
        verbose=False)
    assert len(hj) == len(hp) == 2
    for ej, ep in zip(hj, hp):
        for k in ("loss", "feat_recon_loss", "topo_recon_loss",
                  "topo_sem_recon_loss", "sem_recon_loss", "commit_loss",
                  "env_reg_loss"):
            np.testing.assert_allclose(ep[k], ej[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        assert ep["throughput/steps_per_s"] > 0 and ep["host/sample_ms"] > 0
    p_p, t_p, _ = pretrain_to_jax(model, teach)
    for tree_p, tree_j in ((p_p, _np(pj)), (t_p, _np(tj))):
        lp, lj = _leaves(tree_p), _leaves(tree_j)
        assert set(lp) == set(lj)
        for path, leaf in lj.items():
            np.testing.assert_allclose(lp[path], leaf, rtol=1e-4, atol=1e-4,
                                       err_msg=path)


def test_schedule_horizon_is_epochs_steps(tmp_path):
    """The cosine schedule spans ``epochs`` optimizer steps whatever the
    batch count (JAX builds it with ``steps_per_epoch=1``): after 2 epochs
    of 3 steps with ``epochs = 2`` the schedule stands at step 6 with the
    learning rate 0, as optax's schedule at step 6; each step's rate
    follows ``(1 + cos(min(k, E) pi / E)) / 2``."""
    cfg = _jax_cfg(epochs=2)
    pc = _port_cfg(cfg)
    port_loop.run_pretrain(port_merge([_node_ds(port_synthetic)]), pc,
                           weights=[1.0], device="cpu", verbose=False,
                           save_root=str(tmp_path))
    opt = port_ckpt.load_pytree(str(tmp_path / "full_2.npz"))["opt_state"]
    assert int(opt["sched_step"]) == 6 and float(opt["lr"]) == 0.0
    assert all(float(s) == 6 for s in opt["step"])
    model = PretrainModel(pc)
    o = port_loop.make_pretrain_optimizer(model, pc)
    for k in range(6):
        want = cfg.lr * (1 + np.cos(min(k, 2) * np.pi / 2)) / 2
        assert o.opt.param_groups[0]["lr"] == pytest.approx(want, abs=1e-12)
        for p in o.params:
            p.grad = torch.zeros_like(p)
        o.step()


# --------------------------------------------------------------- k-means

@pytest.mark.parametrize("cosine", [True, False],
                         ids=["cosine", "euclidean"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_kmeans_matches_jax(cosine, masked):
    """``kmeans`` from JAX's initial means (``batched_sample_vectors``):
    the means to 1e-5 and the bins equal; the port's own draw with a
    generator picks rows the mask keeps."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 500, 16)).astype(np.float32)
    if cosine:
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    mask = rng.random(500) < 0.8 if masked else None
    key = jax.random.PRNGKey(3)
    jmask = None if mask is None else jnp.asarray(mask)
    m_j, b_j = jax_cb.kmeans(key, jnp.asarray(x), 32, 10, cosine, mask=jmask)
    init = np.array(jax_cb.batched_sample_vectors(key, jnp.asarray(x), 32,
                                                    mask=jmask))
    tmask = None if mask is None else torch.from_numpy(mask)
    m_p, b_p = port_cb.kmeans(torch.from_numpy(x), 32, 10, cosine,
                              mask=tmask, means=torch.from_numpy(init))
    np.testing.assert_allclose(m_p.numpy(), np.asarray(m_j), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(b_p.numpy(), np.asarray(b_j))
    assert b_p.sum(1).tolist() == [float(500 if mask is None
                                         else mask.sum())] * 4
    drawn = port_cb.batched_sample_vectors(
        torch.from_numpy(x), 64, mask=tmask,
        generator=torch.Generator().manual_seed(0))
    rows = x.reshape(-1, 16)
    if mask is not None:
        rows = x[:, mask].reshape(-1, 16)
    for r in drawn.reshape(-1, 16).numpy():
        assert (np.abs(rows - r).max(1) == 0).any()


def _jax_xh(cfg_vq, params_vq, z):
    xp = jax_vq.linear_apply(params_vq["project_in"], z) \
        if cfg_vq.requires_projection else z
    xh = jax_vq._to_heads(cfg_vq, xp).astype(jnp.float32)
    return jax_cb.l2norm(xh) if cfg_vq.use_cosine_sim else xh


@pytest.mark.parametrize("cosine", [True, False],
                         ids=["cosine", "euclidean"])
def test_vq_kmeans_init_matches_jax(cosine):
    """``vq_kmeans_init`` against JAX's with JAX's initial means handed in:
    ``embed`` to 1e-5, ``cluster_size`` equal, ``embed_avg`` = means x
    bins, ``initted`` set."""
    cfg = jcfg.VQConfig(dim=D, codebook_size=16, codebook_dim=D, heads=4,
                        kmeans_init=True, use_cosine_sim=cosine)
    params, state = (_np(t) for t in jax_vq.vq_init(jax.random.PRNGKey(0),
                                                   cfg))
    rng = np.random.default_rng(1)
    z = rng.standard_normal((300, D)).astype(np.float32)
    mask = np.arange(300) < 280
    key = jax.random.PRNGKey(9)
    p_j, s_j = jax_vq.vq_kmeans_init(key, params, state, cfg,
                                     jnp.asarray(z), mask=jnp.asarray(mask))
    init = np.array(jax_cb.batched_sample_vectors(
        key, _jax_xh(cfg, params, jnp.asarray(z)), 16,
        mask=jnp.asarray(mask)))
    vq = _load(VectorQuantize(pcfg.VQConfig(**dataclasses.asdict(cfg))),
               params, state)
    assert not bool(vq.initted)
    vq_kmeans_init(vq, torch.from_numpy(z), mask=torch.from_numpy(mask),
                   means=torch.from_numpy(init))
    assert bool(vq.initted)
    np.testing.assert_allclose(vq.embed.detach().numpy(),
                               np.asarray(p_j["embed"]), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(vq.cluster_size.numpy(),
                          np.asarray(s_j["cluster_size"]))
    np.testing.assert_allclose(vq.embed_avg.numpy(),
                               np.asarray(s_j["embed_avg"]), rtol=1e-5,
                               atol=1e-4)


def test_maybe_kmeans_init_vq_matches_jax():
    """The finetune's k-means init (JAX ``maybe_kmeans_init_vq``) over the
    eval-mode encoding of the full graph, from the same weights and JAX's
    initial means: the codebook to 1e-5 and the bins equal; an initted
    codebook is left alone."""
    cfg = jcfg.FinetuneConfig(
        encoder=jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="batch", dropout=0.0),
        vq=jcfg.VQConfig(dim=D, codebook_size=16, codebook_dim=D, heads=4,
                         commitment_weight=0.25, kmeans_init=True),
        task="node", num_classes=5)
    params, state = (_np(t) for t in jax_task.task_model_init(
        jax.random.PRNGKey(0), cfg))
    ds_j, ds_p = _node_ds(jax_synthetic, 300), _node_ds(port_synthetic, 300)
    g_j = ds_j.to_graph()
    key = jax.random.PRNGKey(4)
    p_j, s_j = jax_task.maybe_kmeans_init_vq(params, state, cfg, g_j,
                                             rng=key)
    z, _, _ = encoder_apply(params["encoder"], state["encoder"], cfg.encoder,
                            g_j.node_feat, g_j.senders, g_j.receivers,
                            edge_feat=g_j.edge_feat, edge_mask=g_j.edge_mask,
                            node_mask=g_j.node_mask)
    init = np.array(jax_cb.batched_sample_vectors(
        key, _jax_xh(cfg.vq, params["vq"], z), 16, mask=g_j.node_mask))
    pc = pcfg.from_dict(pcfg.FinetuneConfig(), {
        "encoder": vars(cfg.encoder).copy(), "vq": vars(cfg.vq).copy(),
        "task": "node", "num_classes": 5})
    model = task_model_from_jax(params, state, pc)
    g_p = ds_p.to_graph()
    model.train()
    bins = port_task.maybe_kmeans_init_vq(model, pc, g_p,
                                          means=torch.from_numpy(init))
    np.testing.assert_allclose(model.vq.embed.detach().numpy(),
                               np.asarray(p_j["vq"]["embed"]), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(bins.numpy(), np.asarray(
        s_j["vq"]["cluster_size"]))
    assert bool(model.vq.initted) and model.training
    assert port_task.maybe_kmeans_init_vq(model, pc, g_p) is None


def test_maybe_kmeans_seed_vq_matches_jax():
    """The pretrain's k-means seed (JAX ``maybe_kmeans_seed_vq``) over the
    first sampled batch of a fresh ``default_rng(seed)``, from the same
    weights and JAX's initial means: the codebook to 1e-5, bins equal."""
    cfg = _jax_cfg()
    cfg = dataclasses.replace(cfg, vq=dataclasses.replace(
        cfg.vq, kmeans_init=True))
    (params, teacher, state), _, k_init = _jax_init(cfg)
    mj = jax_merge([_node_ds(jax_synthetic)])
    p_j, s_j = jax_loop.maybe_kmeans_seed_vq(params, state, cfg, mj, [1.0],
                                             k_init)
    # JAX's first batch and its initial means
    it0 = jax_sampler.NeighborBatchIterator(
        jax_sampler.CSCGraph.from_edge_index(mj["edge_index"], 400),
        None, None, mj["x"], mj["xe"], jax_sampler.get_train_node_idx(
            mj["ptr"], [1.0], np.random.default_rng(cfg.seed)), BS, [5, 5],
        np.random.default_rng(cfg.seed), indexed=True)
    gm = jax_materialize(next(iter(it0))[0], jnp.asarray(
        mj["node_text_feat"]), jnp.asarray(mj["edge_text_feat"]))
    z0, _, _ = encoder_apply(params["encoder"], state["encoder"],
                             cfg.encoder, gm.node_feat, gm.senders,
                             gm.receivers, edge_feat=gm.edge_feat,
                             edge_mask=gm.edge_mask, node_mask=gm.node_mask)
    init = np.array(jax_cb.batched_sample_vectors(
        k_init, _jax_xh(cfg.vq, params["vq"], z0), 16, mask=gm.node_mask))
    pc = _port_cfg(cfg)
    model, _ = pretrain_from_jax(params, teacher, state, pc)
    mp = port_merge([_node_ds(port_synthetic)])
    node_table, edge_table = _tables(mp)
    bins = port_loop.maybe_kmeans_seed_vq(model, pc, mp, [1.0], node_table,
                                          edge_table,
                                          means=torch.from_numpy(init))
    np.testing.assert_allclose(model.vq.embed.detach().numpy(),
                               np.asarray(p_j["vq"]["embed"]), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(bins.numpy(), np.asarray(
        s_j["vq"]["cluster_size"]))
    assert model.encoder.training


def test_finetune_from_scratch_runs_the_kmeans_init():
    """A finetune with no pretrained weights (a codebook that is not
    initted) used to raise; it k-means-inits the codebook and trains."""
    pc = pcfg.FinetuneConfig(
        encoder=pcfg.EncoderConfig(input_dim=D, hidden_dim=D, dropout=0.0),
        vq=pcfg.VQConfig(dim=D, codebook_size=16, codebook_dim=D, heads=4,
                         commitment_weight=0.25, kmeans_init=True),
        task="node", num_classes=5, epochs=2, repeat=1)
    res = port_ft.run_finetune(_node_ds(port_synthetic, 300), pc,
                               device="cpu")
    vq = res["model"].vq
    assert bool(vq.initted) and vq.embed.abs().sum() > 0
    assert vq.cluster_size.sum(1).tolist() == [300.0] * 4
    assert len(res["epoch_losses"]) == 2
    assert all(np.isfinite(e["loss"]) for e in res["epoch_losses"])


# ------------------------------------------------ checkpoints and resume

def test_checkpoints_are_read_by_jax(tmp_path):
    """The port's ``encoder_1.npz``/``vq_1.npz`` hold JAX's trees (keys and
    shapes of ``pretrain_init``'s encoder and VQ); JAX's
    ``load_pretrained_for_finetune`` + ``restore_like`` read them, and
    JAX's eval encode + quantize from them equals the port's to 1e-4."""
    cfg = _jax_cfg(epochs=2)
    pc = _port_cfg(cfg)
    model, teach, _ = port_loop.run_pretrain(
        port_merge([_node_ds(port_synthetic)]), pc, weights=[1.0],
        device="cpu", max_steps=2, save_root=str(tmp_path), verbose=False)
    assert sorted(os.listdir(tmp_path)) == ["encoder_1.npz", "full_1.npz",
                                            "vq_1.npz"]
    (params, _, state), _, _ = _jax_init(cfg)
    paths = (str(tmp_path / "encoder_1.npz"), str(tmp_path / "vq_1.npz"))
    bundle = jax_loop.load_pretrained_for_finetune(*paths)
    own = port_loop.load_pretrained_for_finetune(*paths)
    assert set(own) == set(bundle)
    for k in bundle:
        lo, lj = _leaves(own[k]), _leaves(bundle[k])
        assert set(lo) == set(lj)
        assert all(np.array_equal(lo[p], lj[p]) for p in lj)
    for part in ("encoder", "vq"):
        for kind, tmpl in (("params", params[part]), ("state", state[part])):
            got = _leaves(bundle[f"{part}_{kind}"])
            want = _leaves(tmpl)
            assert set(got) == set(want), (part, kind)
            assert all(got[k].shape == want[k].shape for k in want)
    enc_p = jax_ckpt.restore_like(params["encoder"],
                                  bundle["encoder_params"])
    enc_s = jax_ckpt.restore_like(state["encoder"], bundle["encoder_state"])
    vq_p = jax_ckpt.restore_like(params["vq"], bundle["vq_params"])
    vq_s = jax_ckpt.restore_like(state["vq"], bundle["vq_state"])
    g = _node_ds(jax_synthetic, 300).to_graph()
    z_j, _, _ = encoder_apply(enc_p, enc_s, cfg.encoder, g.node_feat,
                              g.senders, g.receivers, edge_feat=g.edge_feat,
                              edge_mask=g.edge_mask, node_mask=g.node_mask)
    res_j = jax_vq.vq_apply(vq_p, vq_s, cfg.vq, z_j)
    gp = _node_ds(port_synthetic, 300).to_graph()
    model.eval()
    with torch.no_grad():
        z_p = model.encoder(gp.node_feat, gp.senders, gp.receivers,
                            edge_feat=gp.edge_feat, edge_mask=gp.edge_mask,
                            node_mask=gp.node_mask)
        res = model.vq(z_p)
    np.testing.assert_allclose(z_p.numpy(), np.asarray(z_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(res["quantize"].numpy(),
                               np.asarray(res_j["quantize"]), rtol=1e-4,
                               atol=1e-4)
    assert np.array_equal(res["indices"].numpy(),
                          np.asarray(res_j["indices"]))


def test_resume_restores_every_state_bit_for_bit(tmp_path):
    """``save_checkpoint`` + ``restore_bundle`` into fresh objects give the
    parameters, the teacher, the BatchNorm and VQ state, AdamW's moments and
    steps, the schedule and the step generator bit for bit; a resumed
    ``run_pretrain`` goes on at the saved epoch + 1."""
    cfg = _jax_cfg(epochs=3)
    pc = _port_cfg(cfg)
    merged = port_merge([_node_ds(port_synthetic)])
    model, teach, h1 = port_loop.run_pretrain(
        merged, pc, weights=[1.0], device="cpu", max_steps=4,
        save_root=str(tmp_path), verbose=False)
    assert len(h1) == 2 and sorted(f for f in os.listdir(tmp_path)
                                   if f.startswith("full")) == [
        "full_1.npz", "full_2.npz"]
    # a step past the save, then save and restore by hand
    gen = torch.Generator().manual_seed(3)
    opt = port_loop.make_pretrain_optimizer(model, pc)
    step = port_loop.make_pretrain_step(pc, bs=BS, generator=gen)
    node_table, edge_table = _tables(merged)
    it = port_sampler.NeighborBatchIterator(
        port_sampler.CSCGraph.from_edge_index(merged["edge_index"], 400),
        merged["x"], merged["xe"], np.arange(400), BS, [5, 5],
        np.random.default_rng(0))
    graph = port_loop.batch_graph(next(iter(it))[0], node_table, edge_table,
                                  "cpu", False)
    for _ in range(2):
        step(model, teach, opt, graph)
    port_loop.save_checkpoint(str(tmp_path / "hand"), 7, model, teach,
                              opt=opt, generator=gen)
    m2 = PretrainModel(pc)
    t2 = make_teacher(m2)
    o2 = port_loop.make_pretrain_optimizer(m2, pc)
    g2 = torch.Generator()
    bundle, epoch = port_loop.load_resume_bundle(str(tmp_path / "hand"))
    assert epoch == 7
    port_loop.restore_bundle(bundle, m2, t2, o2, g2)
    for a, b in ((model, m2), (teach, t2)):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    sa, sb = opt.opt.state_dict(), o2.opt.state_dict()
    assert sa["param_groups"][0]["lr"] == sb["param_groups"][0]["lr"]
    assert set(sa["state"]) == set(sb["state"])
    for i, st in sa["state"].items():
        assert all(torch.equal(st[k], sb["state"][i][k]) for k in st)
    assert opt.sched.last_epoch == o2.sched.last_epoch == 2
    assert torch.equal(gen.get_state(), g2.get_state())
    # both go on identically
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=g2))
    # a resumed run starts after the latest full_<epoch>.npz
    _, _, h3 = port_loop.run_pretrain(
        merged, pc, weights=[1.0], device="cpu", resume=True,
        save_root=str(tmp_path), verbose=False)
    assert len(h3) == 1
    assert "full_3.npz" in os.listdir(tmp_path)


def test_run_pretrain_refuses_what_is_not_ported():
    merged = port_merge([_node_ds(port_synthetic)])
    pc = _port_cfg(_jax_cfg())
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        port_loop.run_pretrain(merged, pc, weights=[1.0], device="cpu",
                               mesh=object())
    typed = _merged(port_synthetic, port_merge)
    with pytest.raises(NotImplementedError, match="one edge type"):
        port_loop.run_pretrain(typed, _port_cfg(_jax_cfg(),
                                                fused_minibatch="on"),
                               weights=[1.0, 1.0], device="cpu")
    with pytest.raises(ValueError, match="fused_minibatch"):
        port_loop.batch_layouts_on(_port_cfg(_jax_cfg(),
                                             fused_minibatch="yes"))


# -------------------------------------------------------------- the CLI

def test_pretrain_cli_dataset_mix():
    """``configs/pt_data.yaml``'s mixes, and ``{name: 1.0}`` for a name it
    does not list (the repo's pretrain.py)."""
    assert port_cli.dataset_mix("synthetic") == (
        ["cora_synthetic", "kg_synthetic"], [5, 5])
    assert port_cli.dataset_mix("arxiv_synthetic_pl") == (
        ["arxiv_synthetic_pl"], [1.0])
    names, weights = port_cli.dataset_mix("all")
    assert names[0] == "cora" and weights[-1] == 0.1 and len(names) == 9


def test_pretrain_cli_runs_on_the_cpu():
    """``python -m stemgnn_tpu_torch.pretrain --device cpu`` for 2 steps:
    the checkpoints and a ``config.json`` with JAX's layout; then a resume
    that goes on at epoch 2; the directory is removed afterwards."""
    run_id = f"test_cli_{uuid.uuid4().hex[:8]}"
    root = os.path.join(ROOT, "ckpts", "pretrain_model", run_id)
    base = [sys.executable, "-m", "stemgnn_tpu_torch.pretrain",
            "--pretrain_dataset", "cora_synthetic", "--feat_dim", str(D),
            "--hidden_dim", str(D), "--code_dim", str(D), "--codebook_size",
            "16", "--pretrain_batch_size", "512", "--epochs", "2",
            "--max_steps", "2", "--pretrain_run_id", run_id, "--device",
            "cpu"]
    try:
        proc = subprocess.run(base, cwd=ROOT, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert "[pretrain] epoch 1/2" in proc.stdout
        assert sorted(os.listdir(root)) == ["config.json", "encoder_1.npz",
                                            "full_1.npz", "vq_1.npz"]
        with open(os.path.join(root, "config.json")) as f:
            saved = json.load(f)
        want = jcfg.PretrainConfig()
        assert set(saved) == {"encoder", "vq", "pretrain"}
        assert set(saved["encoder"]) == set(dataclasses.asdict(want.encoder))
        assert set(saved["vq"]) == set(dataclasses.asdict(want.vq))
        assert set(saved["pretrain"]) == set(dataclasses.asdict(want)) - {
            "encoder", "vq"}
        assert saved["encoder"]["hidden_dim"] == D
        proc = subprocess.run(base + ["--resume"], cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert "resumed from epoch 1" in proc.stdout
        assert "[pretrain] epoch 2/2" in proc.stdout
        assert "full_2.npz" in os.listdir(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        for parent in (os.path.dirname(root),
                       os.path.dirname(os.path.dirname(root))):
            try:
                os.rmdir(parent)          # only where left empty
            except OSError:
                break


@pytest.mark.parametrize("flags,needle", [
    (["--data_parallel"], "item 10"), (["--halo_shards", "2"], "item 10"),
    (["--donate"], "--donate"),
    pytest.param(["--text_encoder", "e5"], None, id="flags3-item 11"),
])
def test_pretrain_cli_refuses_what_the_port_does_not_cover(flags, needle):
    """``--text_encoder e5``, once refused naming ROADMAP Queue 1 item 11,
    is accepted as in JAX: the default mix (``synthetic``) is generated
    whatever the encoder, in both registries."""
    argv = ["--device", "cpu", *flags]
    if needle is None:
        args = port_cli.parse(argv)
        assert port_cli.refusals(args) == [] and args.text_encoder == "e5"
        from stemgnn_tpu.data import registry as jax_registry
        from stemgnn_tpu_torch.data import registry as port_registry
        names, _ = port_cli.dataset_mix(args.pretrain_dataset)
        for reg in (port_registry, jax_registry):
            for name in names:
                a = reg.load_dataset(name, feat_dim=8, text_encoder="e5")
                b = reg.load_dataset(name, feat_dim=8)
                assert np.array_equal(np.asarray(a.node_text_feat),
                                      np.asarray(b.node_text_feat))
        return
    with pytest.raises(SystemExit) as info:
        port_cli.main(argv)
    assert needle in str(info.value)


@pytest.mark.parametrize("flags", [["--bf16"], ["--mixed_precision"]])
def test_pretrain_cli_accepts_the_mixed_precision_flags(flags):
    """Once refused (ROADMAP Queue 1 item 4), now accepted: the namespace
    equals the repo CLI's and the config takes JAX's compute dtypes and
    flags (pretrain.py:154-173: ``--bf16`` the encoder,
    ``--mixed_precision`` the encoder, the VQ, the teacher and the loss
    decoders)."""
    spec = importlib.util.spec_from_file_location(
        "repo_pretrain", os.path.join(ROOT, "pretrain.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = port_cli.parse(flags)
    assert not port_cli.refusals(args)
    got = vars(args).copy()
    assert got.pop("device") is None
    assert got == vars(mod.get_args().parse_args(flags))
    cfg = port_cli.make_config(args)
    mp = flags == ["--mixed_precision"]
    assert cfg.encoder.compute_dtype == "bfloat16"
    assert cfg.vq.compute_dtype == ("bfloat16" if mp else "float32")
    assert cfg.teacher_bf16 == cfg.loss_bf16 == mp


@pytest.mark.parametrize("flags", [
    ["--moe"], ["--backbone", "gcn"],
    ["--moe", "--moe_layers", "all", "--lamda_env", "0.1"]])
def test_pretrain_cli_accepts_moe_and_the_other_backbones(flags):
    """Once refused (ROADMAP Queue 1 item 5), now accepted: the namespace
    equals the repo CLI's and the config takes JAX's encoder fields and
    ``lamda_env`` (pretrain.py:140-176)."""
    spec = importlib.util.spec_from_file_location(
        "repo_pretrain", os.path.join(ROOT, "pretrain.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = port_cli.parse(flags)
    assert not port_cli.refusals(args)
    got = vars(args).copy()
    assert got.pop("device") is None
    assert got == vars(mod.get_args().parse_args(flags))
    cfg = port_cli.make_config(args)
    assert cfg.encoder.backbone == (flags[1] if "--backbone" in flags
                                    else "sage")
    assert cfg.encoder.moe == ("--moe" in flags)
    assert cfg.encoder.moe_layers == ("all" if "all" in flags else "none")
    assert cfg.lamda_env == (0.1 if "--lamda_env" in flags else 0.0)


def test_pretrain_cli_flags_mirror_the_repo_cli():
    """The flags, aliases and defaults of the repo's ``pretrain.py``
    (``--use_schedular`` keeps its ``type=bool``: any value is True), and
    ``--use_params`` takes ``configs/pretrain.yaml``'s values."""
    args = port_cli.parse(["--pt_data", "cora_synthetic", "--pt_epochs",
                           "3", "--use_schedular", "False", "--mp"])
    assert args.pretrain_dataset == "cora_synthetic"
    assert args.pretrain_epochs == 3 and args.use_schedular is True
    assert args.mixed_precision
    cfg = port_cli.make_config(port_cli.parse([]))
    assert cfg.encoder == pcfg.EncoderConfig()
    assert (cfg.epochs, cfg.batch_size, cfg.fanout, cfg.lr) == (50, 1024, 10,
                                                               1e-4)
    assert cfg.vq.commitment_weight == 10 and not cfg.vq.kmeans_init
    args = port_cli.parse(["--use_params", "--pt_batch", "64"])
    assert args.pretrain_dataset == "all" and args.pretrain_batch_size == 64
    assert args.pretrain_lr == 0.0001 and args.commit_weight == 10


def test_native_sampler_builds_into_the_port_build_dir():
    path = native_sampler.build()
    assert os.path.dirname(path) == os.path.join(ROOT, "stemgnn_tpu_torch",
                                                 "_build")
    assert os.path.exists(path)
