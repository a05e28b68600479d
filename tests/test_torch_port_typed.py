"""The port's typed-edge slice against the JAX package on the CPU: the
``kg_synthetic`` generator, typed virtual hub layouts, the non-factored
(typed) fused aggregation forward and gradient, one link finetune step, and
the finetune CLI on ``kg_synthetic``.

As in ``test_torch_port_train.py``, JAX takes the fused path on the CPU only
when ``fused_sage_aggregate`` is called directly with ``interpret=True``, so
the aggregation tests call it so, on layouts both packages build alike (v5e
gate profile pinned, ``gwin`` forced on or off); the train-step test runs
the JAX step as the JAX package runs it on the CPU (the f32 gather/segment
aggregation over materialized edge features).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.models import task as jax_task
from stemgnn_tpu.ops import chip_profile as jax_profile
from stemgnn_tpu.ops.edge_layout import build_edge_layout as jax_layout
from stemgnn_tpu.ops.fused_sage import fused_sage_aggregate as jax_fused
from stemgnn_tpu.ops.spmm import gather_scatter_aggregate as jax_gather
from stemgnn_tpu.train import finetune_loop as jax_loop
from stemgnn_tpu.utils import checkpoint as jax_ckpt
from stemgnn_tpu_torch import finetune as port_cli
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import registry
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.ops import fused_sage as port_fused_mod
from stemgnn_tpu_torch.ops.chip_profile import V5E
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout
from stemgnn_tpu_torch.ops.fused_sage import fused_sage_aggregate
from stemgnn_tpu_torch.train import finetune_loop as port_loop
from stemgnn_tpu_torch.train.graph_setup import (describe_layout,
                                                 fused_full_graph)
from stemgnn_tpu_torch.utils.convert import (task_model_from_jax,
                                             task_model_to_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _as_np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _typed_graph(rng, n=600, e=4000, t_rows=11):
    """Hot senders (typed hubs pay) over ``t_rows`` edge types."""
    hot = rng.integers(0, 8, e // 2)
    cold = rng.integers(0, n, e - e // 2)
    s = rng.permutation(np.concatenate([hot, cold])).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    return s, r, rng.integers(0, t_rows, e).astype(np.int32)


def _layouts(s, r, n_pad, gwin, **kw):
    jax_profile.set_profile(jax_profile._V5E)
    try:
        lj = jax_layout(s, r, n_pad, gwin=gwin, edge_chunk=128, **kw)
    finally:
        jax_profile.set_profile(None)
    lp = build_edge_layout(s, r, n_pad, gwin=gwin, edge_chunk=128,
                           profile=V5E, **kw)
    return lj, lp


def test_link_dataset_equals_jax():
    for kw in (dict(), dict(num_entities=500, num_relations=5,
                            num_edges=3000, feat_dim=16, seed=4)):
        a = jax_synthetic.synthetic_link_dataset(**kw)
        b = port_synthetic.synthetic_link_dataset(**kw)
        for f in ("node_text_feat", "edge_text_feat", "x", "xe",
                  "edge_index", "labels"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert (a.num_classes, a.name) == (b.num_classes, b.name)
        for sa, sb in zip(a.splits, b.splits):
            assert all(np.array_equal(sa[k], sb[k]) for k in sa)
    ds = registry.load_dataset("kg_synthetic", feat_dim=8,
                               num_entities=40943, num_edges=93003)
    assert (ds.num_nodes, ds.num_edges, ds.edge_text_feat.shape) == (
        40943, 93003, (11, 8))
    # the real knowledge graphs load from the repository's caches, with
    # one edge text (the factored branch, T = 1)
    for name, size in (("WN18RR", (40_943, 93_003, 11)),
                       ("FB15K237", (14_537, 38_001, 228))):
        kg = registry.load_dataset(name)
        assert (kg.num_nodes, kg.num_edges, kg.num_classes) == size
        assert kg.edge_text_feat.shape == (1, 768)


@pytest.mark.parametrize("mode", ["forced", "auto"])
@pytest.mark.parametrize("t_rows", [5, 11])
def test_typed_hub_layout_equals_jax(t_rows, mode):
    """Typed virtual hubs on the forward side: hub selection (a stable
    argsort of the (node, type) pair frequencies), the count block, the
    hub ids and types and the tail layout equal JAX's; the backward side
    and the scatter-side block stay empty, as in JAX."""
    rng = np.random.default_rng(t_rows)
    s, r, xe = _typed_graph(rng, t_rows=t_rows)
    kw = dict(xe_ids=xe, num_edge_types=t_rows, hub_size=64,
              sc_hub_size=64, feat_dim_hint=32)
    if mode == "forced":
        kw["hub_min_coverage"] = -1.0
    lj, lp = _layouts(s, r, 640, "off", **kw)
    assert lj.hub_r is not None and lp.hub_r is not None
    assert lj.hub_s is None and lp.hub_s is None
    hj, hp = lj.hub_r, lp.hub_r
    assert hp.sc_cnt is None and hj.sc_cnt is None
    assert (hp.hub_size, hp.sc_size) == (hj.hub_size, hj.sc_size)
    assert hp.coverage == hj.coverage > 0
    for f in ("hub_ids", "hub_xe", "cnt"):
        a, b = _as_np(getattr(hp, f)), _as_np(getattr(hj, f))
        assert a.shape == b.shape and np.array_equal(a, b), f
    for f in dataclasses.fields(hp.tail):
        if f.name in ("plan_r", "plan_s"):     # the port's own row plans
            continue
        a, b = getattr(hp.tail, f.name), getattr(hj.tail, f.name)
        if isinstance(a, torch.Tensor):
            assert np.array_equal(_as_np(a), _as_np(b)), f.name
    # every valid edge is a hub edge or a tail edge, once
    covered = float(_as_np(hp.cnt).sum())
    assert covered + int(hp.tail.mask_r.sum()) == len(s)


def test_typed_hubs_only_up_to_32_types():
    """T > 32: no typed hub block on either side (JAX returns None there
    too)."""
    rng = np.random.default_rng(3)
    s, r, xe = _typed_graph(rng, t_rows=40)
    kw = dict(xe_ids=xe, num_edge_types=40, hub_size=64,
              hub_min_coverage=-1.0)
    lj, lp = _layouts(s, r, 640, "off", **kw)
    assert lj.hub_r is None and lp.hub_r is None and lp.hub_s is None


def _jax_loss(lj, table, x, w, bf16):
    def loss(xj):
        out = jax_fused(xj, lj, jnp.asarray(table), reduce="mean", relu=True,
                        bf16_messages=bf16, interpret=True)
        return jnp.sum(out * w), out
    (_, out), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    return np.asarray(out), np.asarray(g)


@pytest.mark.parametrize("messages", ["bf16", "f32"])
@pytest.mark.parametrize("hubs", ["none", "typed"])
@pytest.mark.parametrize("gwin", ["on", "off"])
@pytest.mark.parametrize("t_rows", [5, 11])
def test_typed_fused_sage_value_and_grad_match_jax(t_rows, gwin, hubs,
                                                   messages):
    """Forward and d/dx of sum(out * w) through the port's autograd
    Function against JAX's custom VJP on typed layouts: without hubs and
    with typed virtual hubs, with the in-kernel gather (kernel 2's xe mode)
    and without it (the messages + kernel 1), and in the backward kernel 3
    (bf16 messages) or the rebuilt messages' mask + kernel 1 (f32).

    bf16 messages: both sides round the same bf16 messages and gp = w/deg
    and sum them in f32 in another order: rtol/atol 1e-4.  f32 messages:
    JAX's Pallas kernel splits each f32 message into two bf16 halves
    (``fast=False``, ~2^-16 relative), so the port is held to it at 1e-4
    and to JAX's exact f32 gather/segment-sum aggregation (the same
    function over materialized edge features) at 1e-5."""
    rng = np.random.default_rng(7 + t_rows)
    n, e, n_pad, d = 600, 4000, 640, 32
    s, r, xe = _typed_graph(rng, n, e, t_rows)
    kw = dict(xe_ids=xe, num_edge_types=t_rows, feat_dim_hint=d)
    if hubs == "typed":
        kw.update(hub_size=16, hub_min_coverage=-1.0)
    lj, lp = _layouts(s, r, n_pad, gwin, **kw)
    assert lp.use_gwin_r == (gwin == "on")
    assert (lp.hub_r is not None) == (hubs == "typed")
    if hubs == "typed":
        assert lp.hub_r.hub_xe is not None
        assert lp.hub_r.tail.use_gwin_r == (gwin == "on")
    x = np.zeros((n_pad, d), np.float32)
    x[:n] = rng.standard_normal((n, d))
    w = rng.standard_normal((n_pad, d)).astype(np.float32)
    table = rng.standard_normal((t_rows, d)).astype(np.float32)
    bf16 = messages == "bf16"

    out_j, g_j = _jax_loss(lj, table, x, w, bf16)
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    out_p = fused_sage_aggregate(xt, lp, tt, reduce="mean", relu=True,
                                 bf16_messages=bf16)
    (out_p * torch.from_numpy(w)).sum().backward()
    out_p, g_p = out_p.detach().numpy(), xt.grad.numpy()
    np.testing.assert_allclose(out_p, out_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_p, g_j, rtol=1e-4, atol=1e-4)
    assert torch.equal(tt.grad, torch.zeros_like(tt))
    if not bf16:
        def exact(xj):
            out = jax_gather(xj, jnp.asarray(s), jnp.asarray(r),
                             edge_feat=jnp.asarray(table[xe]),
                             num_nodes=n_pad, reduce="mean", relu=True)
            return jnp.sum(out * w), out
        (_, out_x), g_x = jax.value_and_grad(exact, has_aux=True)(
            jnp.asarray(x))
        np.testing.assert_allclose(out_p, np.asarray(out_x), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g_p, np.asarray(g_x), rtol=1e-5,
                                   atol=1e-5)


D = 32
T = 11


def _dataset(pkg):
    return pkg.synthetic_link_dataset(num_entities=300, num_relations=T,
                                      num_edges=1500, feat_dim=D, seed=3)


def _jax_task(dropout=0.0, seed=0):
    """A JAX link FinetuneConfig at width D and its task-model trees, with
    non-trivial BatchNorm statistics."""
    cfg = jcfg.FinetuneConfig(
        encoder=jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="batch", dropout=dropout),
        vq=jcfg.VQConfig(dim=D, codebook_size=16, codebook_dim=D, heads=4,
                         commitment_weight=0.25),
        task="link", num_classes=T, lr=1e-3, hub_size=64, sc_hub_size=64)
    params, state = jax_task.task_model_init(jax.random.PRNGKey(seed), cfg)
    to_np = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731
    params, state = to_np(params), to_np(state)
    rng = np.random.default_rng(seed)
    for bn in state["encoder"]["norms"]:
        bn["mean"] = rng.normal(0, 0.1, D).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, D).astype(np.float32)
    return cfg, params, state


def _port_cfg(cfg):
    return pcfg.from_dict(pcfg.FinetuneConfig(), {
        "encoder": vars(cfg.encoder).copy(), "vq": vars(cfg.vq).copy(),
        **{k: getattr(cfg, k) for k in ("task", "num_classes", "lr",
                                        "hub_size", "sc_hub_size")}})


def _edge_rows(ds, e_pad):
    y = np.zeros(e_pad, np.int64)
    y[:ds.num_edges] = ds.labels
    mask = np.zeros(e_pad, bool)
    mask[:ds.num_edges] = ds.splits[0]["train"]
    return y, mask


def _jax_step(cfg, params, state, ds):
    """One JAX link train step (``_make_node_steps(cfg, "link")`` +
    ``optax.adamw``) on the plain CPU graph."""
    graph = ds.to_graph()
    y, mask = _edge_rows(ds, graph.num_edges_padded)
    train_step, _ = jax_loop._make_node_steps(cfg, "link")
    tx = optax.adamw(cfg.lr, weight_decay=0.01)
    trainable, frozen = jax_loop._split_params(params, cfg)
    trainable, _, new_state, losses, _ = train_step(
        trainable, frozen, tx.init(trainable), state, jax.random.PRNGKey(0),
        jnp.asarray(mask), graph, jnp.asarray(y.astype(np.int32)), tx)
    return ({k: float(v) for k, v in losses.items()},
            jax.tree_util.tree_map(np.asarray, trainable),
            jax.tree_util.tree_map(np.asarray, new_state))


def _port_graph(ds, pc, use_layout):
    return fused_full_graph(ds, pc, device="cpu", use_layout=use_layout,
                            profile=V5E)


def _port_step(cfg, params, state, ds, use_layout):
    pc = _port_cfg(cfg)
    model = task_model_from_jax(params, state, pc)
    # the link model's trees carry across both ways unchanged
    back_p, back_s = task_model_to_jax(model)
    for path, leaf in _leaves(params).items():
        assert np.array_equal(_leaves(back_p)[path], leaf), path
    for path, leaf in _leaves(state).items():
        assert np.array_equal(_leaves(back_s)[path], leaf), path
    g = _port_graph(ds, pc, use_layout)
    if use_layout:
        assert g.layout.hub_r is not None and g.layout.hub_r.hub_xe is not None
        assert g.layout.hub_s is None and g.edge_table.shape == (T, D)
    y, mask = _edge_rows(ds, g.num_edges_padded)
    _, train_step, _ = port_loop._make_node_steps(pc, "link")
    trainable, _ = port_loop._split_params(model, pc)
    opt = port_loop.make_optimizer(trainable, pc)
    losses = train_step(model, opt, torch.from_numpy(mask), g,
                        torch.from_numpy(y))
    params_new, state_new = task_model_to_jax(model)
    return {k: float(v) for k, v in losses.items()}, params_new, state_new


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.mark.parametrize("route", ["plain_f32", "layout_bf16"])
def test_link_train_step_matches_jax(route):
    """One full-batch link finetune step on ``kg_synthetic`` (dropout 0)
    from the same converted weights: the loss parts, every updated
    trainable parameter and the BatchNorm running state, with the two
    routes and tolerances of ``test_finetune_train_step_matches_jax``.
    ``layout_bf16`` runs the typed layout (typed virtual hubs, kernel 2's
    xe mode in the forward, kernel 3 in the backward, their plain versions
    on the CPU)."""
    cfg, params, state = _jax_task()
    ds_j, ds_p = _dataset(jax_synthetic), _dataset(port_synthetic)
    want_loss, want_p, want_s = _jax_step(cfg, params, state, ds_j)
    got_loss, got_p, got_s = _port_step(cfg, params, state, ds_p,
                                        use_layout=route == "layout_bf16")
    f32 = route == "plain_f32"
    tol = dict(rtol=1e-5, atol=1e-5) if f32 else dict(rtol=3e-2, atol=3e-2)
    for k in ("loss", "act_loss", "jac_loss", "env_loss"):
        np.testing.assert_allclose(got_loss[k], want_loss[k], **tol)
    got_leaves = _leaves({k: v for k, v in got_p.items() if k != "vq"})
    want_leaves = _leaves(want_p)
    assert set(got_leaves) == set(want_leaves)
    sign_tol = dict(rtol=0, atol=2.1 * cfg.lr)
    for path, leaf in want_leaves.items():
        noise = "lin_l" in str(path) and "'b'" in str(path)
        np.testing.assert_allclose(got_leaves[path], leaf,
                                   **(tol if f32 and not noise else sign_tol),
                                   err_msg=str(path))
    for i, ns in enumerate(want_s["encoder"]["norms"]):
        gs = got_s["encoder"]["norms"][i]
        for k in ("mean", "var"):
            np.testing.assert_allclose(gs[k], ns[k], **tol)
        assert int(gs["count"]) == int(ns["count"]) == 1
    for path, leaf in _leaves(params["vq"]).items():
        assert np.array_equal(_leaves(got_p["vq"])[path], leaf)


@pytest.mark.parametrize("gwin", ["on", "off"])
def test_link_step_routes_through_kernel_three(gwin, monkeypatch):
    """The route a CUDA link step takes, counted on the CPU through the
    kernels' plain versions: 2 forward aggregations (kernel 2's xe mode
    with the gate open, the messages + kernel 1 with it shut; on the typed
    hub tail where the auto gate picks hubs) and 1
    backward (layer 2 only) through kernel 3; an evaluation takes the 2
    forward ones."""
    calls = {"gathered_scatter_rows_sorted": 0, "scatter_rows_sorted": 0,
             "masked_scatter_rows_sorted": 0}

    def counting(name):
        fn = getattr(port_fused_mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(port_fused_mod, name, wrapped)
    for name in calls:
        counting(name)
    cfg, params, state = _jax_task(dropout=0.15)
    ds = _dataset(port_synthetic)
    pc = _port_cfg(cfg)
    model = task_model_from_jax(params, state, pc)
    g = fused_full_graph(ds, pc, device="cpu", use_layout=True, gwin=gwin)
    hub = g.layout.hub_r                  # auto mode on the H100 profile
    line = describe_layout(g.layout, T)
    assert "T=11" in line and "masked_scatter_rows_sorted" in line
    assert ("no typed hubs" in line) == (hub is None)
    assert hub is None or (hub.hub_xe is not None and g.layout.hub_s is None)
    _, train_step, eval_step = port_loop._make_node_steps(pc, "link")
    trainable, _ = port_loop._split_params(model, pc)
    opt = port_loop.make_optimizer(trainable, pc)
    y, mask = _edge_rows(ds, g.num_edges_padded)
    losses = train_step(model, opt, torch.from_numpy(mask), g,
                        torch.from_numpy(y), torch.Generator())
    assert all(np.isfinite(float(v)) for v in losses.values())
    fwd = ("gathered_scatter_rows_sorted" if gwin == "on"
           else "scatter_rows_sorted")
    want = dict.fromkeys(calls, 0)
    want.update({fwd: 2, "masked_scatter_rows_sorted": 1})
    assert calls == want
    probs = eval_step(model, g)
    assert probs.shape == (g.num_edges_padded, T)
    want[fwd] = 4
    assert calls == want


def test_finetune_cli_trains_kg_synthetic_on_the_cpu(tmp_path):
    """``python -m stemgnn_tpu_torch.finetune --finetune_dataset
    kg_synthetic --device cpu`` from a checkpoint that the JAX package
    wrote: two epochs of the link task print their loss and accuracies and
    the final lines."""
    cfg, params, state = _jax_task()
    for part in ("encoder", "vq"):
        jax_ckpt.save_pytree(str(tmp_path / f"{part}_50.npz"),
                             {"params": params[part], "state": state[part]})
    proc = subprocess.run(
        [sys.executable, "-m", "stemgnn_tpu_torch.finetune",
         "--finetune_dataset", "kg_synthetic", "--feat_dim", str(D),
         "--hidden_dim", str(D), "--code_dim", str(D), "--codebook_size",
         "16", "--pretrain_path", str(tmp_path), "--pretrain_model_epoch",
         "50", "--epochs", "2", "--repeat", "1", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "Loaded pretrained encoder and VQ." in out
    assert "[split 0] epoch 0: loss" in out and "[split 0] epoch 1: loss" \
        in out
    assert "final/test:" in out


def test_finetune_cli_still_refuses_graph_tasks():
    """The graph tasks run (``tests/test_torch_port_graph.py``), now with
    the bf16 evaluation too (``--eval_bf16 1``, once refused: its config
    reaches ``run_finetune`` as JAX's does, tests/test_torch_port_mixed.py);
    a chem dataset that needs a download raises JAX's
    ``FileNotFoundError``."""
    args = port_cli.parse(["--finetune_dataset", "mol_synthetic",
                           "--eval_bf16", "1"])
    assert not port_cli.refusals(args)
    cfg = port_cli.make_config(args, 4)
    assert cfg.eval_bf16 and cfg.task == "graph"
    assert cfg.encoder.compute_dtype == "float32"
    with pytest.raises(FileNotFoundError, match="chempcba"):
        port_cli.main(["--device", "cpu", "--finetune_dataset", "chempcba",
                       "--use_params", "--debug"])
