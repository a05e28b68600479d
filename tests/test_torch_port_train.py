"""The port's training slice against the JAX package on the CPU: the fused
aggregation's forward and gradient, BatchNorm's training statistics, one
full finetune train step, and the finetune CLI.

JAX on the CPU takes the fused path only when ``fused_sage_aggregate`` is
called directly with ``interpret=True`` (its ``sage_aggregate`` routes around
it off the TPU, ``spmm.py:93``), so the aggregation tests call it so, with
layouts both packages build alike (v5e gate profile pinned, ``gwin`` forced
on or off).  The train-step test runs the JAX step as the JAX package runs it
on the CPU: the f32 gather/segment-sum aggregation.
"""

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
from stemgnn_tpu.nn.layers import batchnorm_apply
from stemgnn_tpu.ops import chip_profile as jax_profile
from stemgnn_tpu.ops.edge_layout import build_edge_layout as jax_layout
from stemgnn_tpu.ops.fused_sage import fused_sage_aggregate as jax_fused
from stemgnn_tpu.train import finetune_loop as jax_loop
from stemgnn_tpu.utils import checkpoint as jax_ckpt
from stemgnn_tpu_torch import finetune as port_cli
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.nn.layers import BatchNorm
from stemgnn_tpu_torch.ops import fused_sage as port_fused_mod
from stemgnn_tpu_torch.ops.chip_profile import V5E
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout
from stemgnn_tpu_torch.ops.fused_sage import fused_sage_aggregate
from stemgnn_tpu_torch.train import finetune_loop as port_loop
from stemgnn_tpu_torch.train.graph_setup import fused_full_graph
from stemgnn_tpu_torch.utils.convert import (task_model_from_jax,
                                             task_model_to_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _two_sided_skew(rng, n=600, e=4000):
    """Hot senders and hot receivers: the hub blocks of both directions
    (and the scatter-side blocks) cover a real share of the edges."""
    def skew():
        hot = rng.integers(0, 8, e // 2).astype(np.int32)
        cold = rng.integers(0, n, e - e // 2).astype(np.int32)
        return rng.permutation(np.concatenate([hot, cold])).astype(np.int32)
    return skew(), skew()


def _layouts(s, r, n_pad, gwin, **kw):
    jax_profile.set_profile(jax_profile._V5E)
    try:
        lj = jax_layout(s, r, n_pad, gwin=gwin, edge_chunk=128, **kw)
    finally:
        jax_profile.set_profile(None)
    lp = build_edge_layout(s, r, n_pad, gwin=gwin, edge_chunk=128,
                           profile=V5E, **kw)
    return lj, lp


@pytest.mark.parametrize("with_t0", [False, True])
@pytest.mark.parametrize("hubs", ["none", "hub", "sc_hub"])
@pytest.mark.parametrize("gwin", ["on", "off"])
def test_fused_sage_value_and_grad_match_jax(gwin, hubs, with_t0):
    """Forward and d/dx of sum(out * w) through the port's autograd
    Function against JAX's custom VJP, bf16 messages, on the no-hub
    (whole-direction), hub_r/hub_s and scatter-side-hub layouts, with the
    in-kernel gather (gwin on: kernel 2 in the forward and backward tails)
    and without it (gwin off: gather + kernel 1 with the gate epilogue).
    The upstream gradient w is the same on both sides, so gp = w / deg
    rounds to the same bf16 values and the sums differ only in order:
    rtol/atol 1e-4."""
    rng = np.random.default_rng(7)
    n, e, n_pad, d = 600, 4000, 640, 32
    s, r = _two_sided_skew(rng, n, e)
    kw = {} if hubs == "none" else dict(
        hub_size=8, hub_min_coverage=-1.0,
        sc_hub_size=8 if hubs == "sc_hub" else 0)
    lj, lp = _layouts(s, r, n_pad, gwin, feat_dim_hint=d, **kw)
    assert lp.use_gwin_r == (gwin == "on")
    if hubs != "none":
        assert lp.hub_r is not None and lp.hub_s is not None
        assert lp.hub_s.tail.use_gwin_s == (gwin == "on")
    if hubs == "sc_hub":
        assert lp.hub_r.sc_cnt is not None and lp.hub_s.sc_cnt is not None
    x = np.zeros((n_pad, d), np.float32)
    x[:n] = rng.standard_normal((n, d))
    w = rng.standard_normal((n_pad, d)).astype(np.float32)
    table = rng.standard_normal((1, d)).astype(np.float32) if with_t0 \
        else None

    def loss_j(xj):
        out = jax_fused(xj, lj, None if table is None else jnp.asarray(table),
                        reduce="mean", relu=True, bf16_messages=True,
                        interpret=True)
        return jnp.sum(out * w), out
    (_, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    out_p = fused_sage_aggregate(
        xt, lp, None if table is None else torch.from_numpy(table),
        reduce="mean", relu=True, bf16_messages=True)
    (out_p * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("gwin", ["on", "off"])
def test_training_step_routes_and_skips_layer_one_backward(gwin,
                                                           monkeypatch):
    """The route a CUDA step takes, counted on the CPU through the kernels'
    plain versions: 2 forward tails (one per layer) + 1 backward tail
    (layer 2 only: layer 1's input is the node features, which need no
    gradient) through kernel 2 with the gate open, through kernel 1 with it
    closed; an eval forward takes 2."""
    calls = {"gathered": 0, "scatter": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(port_fused_mod, "gathered_scatter_rows_sorted",
                        counting("gathered",
                                 port_fused_mod.gathered_scatter_rows_sorted))
    monkeypatch.setattr(port_fused_mod, "scatter_rows_sorted",
                        counting("scatter",
                                 port_fused_mod.scatter_rows_sorted))
    cfg, params, state = _jax_task(dropout=0.15)
    ds = _dataset(port_synthetic)
    pc = _port_cfg(cfg)
    model = task_model_from_jax(params, state, pc)
    g = fused_full_graph(ds, pc, device="cpu", use_layout=True, gwin=gwin)
    assert g.layout.hub_r is not None
    loss_fn, train_step, eval_step = port_loop._make_node_steps(pc)
    trainable, frozen = port_loop._split_params(model, pc)
    assert frozen and all(k.startswith("vq.") for k in frozen)
    assert not any(p.requires_grad for p in frozen.values())
    opt = port_loop.make_optimizer(trainable, pc)
    y = torch.zeros(g.num_nodes_padded, dtype=torch.long)
    y[:ds.num_nodes] = torch.from_numpy(ds.labels)
    mask = g.node_mask & (torch.arange(g.num_nodes_padded) < 100)
    vq_before = {k: v.clone() for k, v in frozen.items()}
    dec_before = model.decoder.w.detach().clone()
    losses = train_step(model, opt, mask, g, y, torch.Generator())
    kernel = "gathered" if gwin == "on" else "scatter"
    other = "scatter" if gwin == "on" else "gathered"
    assert calls[kernel] == 3 and calls[other] == 0
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert not torch.equal(model.decoder.w, dec_before)
    assert all(torch.equal(v, vq_before[k]) for k, v in frozen.items())
    eval_step(model, g)
    assert calls[kernel] == 5


def test_batchnorm_training_matches_jax():
    """Batch statistics over the node_mask rows, the running-stat update
    (momentum 0.1, unbiased variance, count) and the gradients."""
    rng = np.random.default_rng(8)
    n, d = 200, 16
    x = rng.standard_normal((n, d)).astype(np.float32) * 2 + 0.5
    x[150:] = 1e3                                  # padded rows: ignored
    mask = np.arange(n) < 150
    params = {"scale": rng.standard_normal(d).astype(np.float32),
              "bias": rng.standard_normal(d).astype(np.float32)}
    state = {"mean": rng.standard_normal(d).astype(np.float32),
             "var": rng.random(d).astype(np.float32) + 0.5,
             "count": np.int32(3)}
    w = rng.standard_normal((n, d)).astype(np.float32)

    def loss_j(x, p):
        y, ns = batchnorm_apply(p, state, x, training=True,
                                mask=jnp.asarray(mask))
        return jnp.sum(y * w), (y, ns)
    (_, (y_j, ns_j)), (gx_j, gp_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(jnp.asarray(x), params)

    bn = BatchNorm(d)
    bn.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in {**params, **state}.items()})
    bn.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    y_p = bn(xt, mask=torch.from_numpy(mask))
    (y_p * torch.from_numpy(w)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_p.detach().numpy(), np.asarray(y_j), **tol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(ns_j[k]), **tol)
    assert int(bn.count) == int(ns_j["count"]) == 4
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(bn.scale.grad.numpy(),
                               np.asarray(gp_j["scale"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp_j["bias"]),
                               rtol=1e-4, atol=1e-4)


D = 32
NUM_CLASSES = 5


def _dataset(pkg):
    return pkg.synthetic_node_dataset(num_nodes=400, num_classes=NUM_CLASSES,
                                      feat_dim=D, avg_degree=8,
                                      pref_attach=1.1, num_splits=1, seed=3)


def _jax_task(dropout=0.0, seed=0):
    """A JAX FinetuneConfig at width D (4 heads of D-wide codes, so the VQ
    projects) and its task-model trees, with non-trivial BatchNorm
    statistics."""
    cfg = jcfg.FinetuneConfig(
        encoder=jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="batch", dropout=dropout),
        vq=jcfg.VQConfig(dim=D, codebook_size=16, codebook_dim=D, heads=4,
                         commitment_weight=0.25),
        task="node", num_classes=NUM_CLASSES, lr=1e-3, hub_size=64,
        sc_hub_size=64)
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


def _jax_step(cfg, params, state, ds):
    """One JAX train step (``_make_node_steps`` + ``optax.adamw``) on the
    plain CPU graph: (loss parts, new trainable params, new state)."""
    graph = ds.to_graph()
    n_pad = graph.num_nodes_padded
    y = np.zeros(n_pad, np.int32)
    y[:ds.num_nodes] = ds.labels
    mask = np.zeros(n_pad, bool)
    mask[:ds.num_nodes] = ds.splits[0]["train"]
    train_step, _ = jax_loop._make_node_steps(cfg, "node")
    tx = optax.adamw(cfg.lr, weight_decay=0.01)
    trainable, frozen = jax_loop._split_params(params, cfg)
    opt_state = tx.init(trainable)
    trainable, _, new_state, losses, _ = train_step(
        trainable, frozen, opt_state, state, jax.random.PRNGKey(0),
        jnp.asarray(mask), graph, jnp.asarray(y), tx)
    return ({k: float(v) for k, v in losses.items()},
            jax.tree_util.tree_map(np.asarray, trainable),
            jax.tree_util.tree_map(np.asarray, new_state))


def _port_step(cfg, params, state, ds, use_layout):
    pc = _port_cfg(cfg)
    model = task_model_from_jax(params, state, pc)
    g = fused_full_graph(ds, pc, device="cpu", use_layout=use_layout)
    if use_layout:
        assert g.layout.hub_r is not None and g.layout.use_gwin_r
    n_pad = g.num_nodes_padded
    y = torch.zeros(n_pad, dtype=torch.long)
    y[:ds.num_nodes] = torch.from_numpy(ds.labels)
    mask = torch.zeros(n_pad, dtype=torch.bool)
    mask[:ds.num_nodes] = torch.from_numpy(ds.splits[0]["train"])
    _, train_step, _ = port_loop._make_node_steps(pc)
    trainable, _ = port_loop._split_params(model, pc)
    opt = port_loop.make_optimizer(trainable, pc)
    losses = train_step(model, opt, mask, g, y)
    params_new, state_new = task_model_to_jax(model)
    return {k: float(v) for k, v in losses.items()}, params_new, state_new


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.mark.parametrize("route", ["plain_f32", "layout_bf16"])
def test_finetune_train_step_matches_jax(route):
    """One full-batch finetune step (dropout 0) from the same converted
    weights: the loss parts, every updated trainable parameter (encoder and
    decoder; the frozen VQ stays out) and the BatchNorm running state.

    The JAX step runs the f32 gather/segment-sum aggregation (its CPU
    path).  ``plain_f32``: the port's plain graph runs the same arithmetic,
    so the loss agrees to 1e-5 and each parameter to 1e-5 after the AdamW
    update.  ``layout_bf16``: the port's layout path (hub split + the
    in-kernel-gather tails, bf16 messages, their plain versions on the CPU)
    rounds each message to bf16, so the loss and the BatchNorm state get the
    bf16-message tolerance 3e-2 of the encode test; AdamW's first step moves
    each parameter by about lr * sign(grad), so a parameter whose gradient
    flips sign under that rounding can differ by 2 * lr: tolerance 2.1 * lr.
    On both routes the SAGE biases ``lin_l.b`` get that tolerance too: the
    BatchNorm after them subtracts the batch mean, so their gradient is f32
    rounding noise of about Adam's eps (1e-8), and Adam's step on it moves
    them by an amount and sign the noise picks (measured 5e-5 on JAX's side).
    """
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
    # the frozen VQ is unchanged
    for path, leaf in _leaves(params["vq"]).items():
        assert np.array_equal(_leaves(got_p["vq"])[path], leaf)


@pytest.mark.parametrize("flags,needle", [
    pytest.param(["--finetune_dataset", "mol_synthetic", "--text_encoder",
                  "e5"], None, id="flags0---text_encoder e5"),
    (["--donate"], "--donate"),
    (["--halo_shards", "2"], "--halo_shards"),
    (["--halo_order", "rcm"], "--halo_order"),
    (["--reorder", "rcm"], "--reorder rcm"),
])
def test_finetune_cli_refuses_what_the_slice_does_not_cover(flags, needle):
    """``--text_encoder e5`` with ``mol_synthetic``, once refused, is
    accepted as in JAX: the generated molecules ignore the encoder, so the
    bundle equals the hash run's in both registries."""
    argv = ["--device", "cpu", "--debug", *flags]
    if needle is None:
        assert port_cli.refusals(port_cli.parse(argv)) == []
        from stemgnn_tpu.data import registry as jax_registry
        from stemgnn_tpu_torch.data import registry as port_registry
        for reg in (port_registry, jax_registry):
            (ga, la, _), (gb, lb, _) = (
                reg.load_dataset("mol_synthetic", feat_dim=8,
                                 text_encoder=enc) for enc in ("e5", "hash"))
            assert len(ga) == len(gb) and np.array_equal(la, lb, True)
        return
    with pytest.raises(SystemExit) as info:
        port_cli.main(argv)
    assert needle in str(info.value)


@pytest.mark.parametrize("flags", [
    ["--batch_size", "32"],
    ["--batch_size", "32", "--eval_chunked", "1"],
    ["--eval_chunked", "1"],
    ["--save_model", "{tmp}/model.npz"],
    ["--use_vq", "0"],
    ["--freeze_vq", "0"],
    ["--bf16"],
    ["--eval_bf16", "1"],
    ["--moe", "--moe_layers", "last", "--lamda_env", "0.1"],
    ["--backbone", "gcn"],
])
def test_finetune_cli_runs_what_the_slice_now_covers(flags, tmp_path):
    """The flag values the CLI used to refuse run now: minibatches, the
    layer-wise chunked evaluation, the task-model export, the no-VQ bypass,
    a trained codebook, the bf16 encoder, ``--eval_bf16 1`` (accepted
    on a node task, where it changes nothing, as in JAX), an MoE last
    layer with ``--lamda_env`` (the scaled env term in the loss) and the
    gcn backbone, one epoch of cora_synthetic at width D."""
    flags = [f.format(tmp=tmp_path) for f in flags]
    res = port_cli.main(["--device", "cpu", "--debug", "--finetune_dataset",
                         "cora_synthetic", "--feat_dim", str(D),
                         "--hidden_dim", str(D), "--code_dim", str(D),
                         "--codebook_size", "16", "--epochs", "1",
                         "--repeat", "1", *flags])
    assert np.isfinite(res["epoch_losses"][0]["loss"])
    if "--save_model" in flags:
        assert os.path.exists(flags[-1]) and res["best_pred"] is not None
    if "--batch_size" in flags:
        assert res["history"][0]["batches"] == -(-140 // 32)
    assert (res["graph"] is None) == ("--batch_size" in flags
                                      and "--eval_chunked" in flags)
    assert res["cfg"].encoder.compute_dtype == (
        "bfloat16" if "--bf16" in flags else "float32")
    assert res["cfg"].eval_bf16 == ("--eval_bf16" in flags)
    assert res["cfg"].encoder.backbone == ("gcn" if "gcn" in flags
                                           else "sage")
    env = res["epoch_losses"][0]["env_loss"]
    assert (env < 0) if "--moe" in flags else env == 0.0


def test_finetune_cli_trains_on_the_cpu(tmp_path):
    """``python -m stemgnn_tpu_torch.finetune --device cpu`` from a
    checkpoint that the JAX package wrote: two epochs print their loss and
    accuracies and the final lines."""
    cfg, params, state = _jax_task()
    for part in ("encoder", "vq"):
        jax_ckpt.save_pytree(str(tmp_path / f"{part}_50.npz"),
                             {"params": params[part], "state": state[part]})
    proc = subprocess.run(
        [sys.executable, "-m", "stemgnn_tpu_torch.finetune",
         "--finetune_dataset", "cora_synthetic", "--feat_dim", str(D),
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


def test_finetune_refuses_a_vq_without_kmeans_init(tmp_path):
    """A codebook that is not initted used to be refused; the k-means init
    is ported now, so the CLI seeds it (JAX finetune_loop.py:584-586) and
    trains: the codebook ends initted, its codes unit rows (cosine), every
    valid node counted once per head in ``cluster_size``, and the frozen
    codebook equal to ``embed_avg / cluster_size`` re-normalized where a
    code has nodes (the k-means means, untouched by training)."""
    cfg, params, state = _jax_task()
    state["vq"]["initted"] = np.asarray(False)
    for part in ("encoder", "vq"):
        jax_ckpt.save_pytree(str(tmp_path / f"{part}_50.npz"),
                             {"params": params[part], "state": state[part]})
    res = port_cli.main(["--finetune_dataset", "cora_synthetic", "--feat_dim",
                         str(D), "--hidden_dim", str(D), "--code_dim", str(D),
                         "--codebook_size", "16", "--pretrain_path",
                         str(tmp_path), "--pretrain_model_epoch", "50",
                         "--epochs", "1", "--repeat", "1", "--device", "cpu"])
    vq = res["model"].vq
    assert bool(vq.initted)
    embed = vq.embed.detach()
    torch.testing.assert_close(torch.linalg.vector_norm(embed, dim=-1),
                               torch.ones(embed.shape[:2]))
    n = res["graph"].n_node
    assert vq.cluster_size.sum(1).tolist() == [float(n)] * embed.shape[0]
    used = vq.cluster_size > 0
    mean = vq.embed_avg / torch.clamp(vq.cluster_size, min=1.0)[..., None]
    torch.testing.assert_close(embed[used], mean[used], rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(res["epoch_losses"][0]["loss"])
