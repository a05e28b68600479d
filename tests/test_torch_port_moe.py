"""The port's MoE-SAGE encoder, its environment regularizer (``--moe
--lamda_env``) and the paths that train it, against the JAX package on the
CPU: the encoder in training with JAX's Gumbel draws handed over (``z``,
``env_reg``, the router statistics and the gradients), the bf16 MoE layer
at a sender of more than 256 out-edges, one finetune step's gradients with
``lamda_env > 0``, a 3-epoch ``run_finetune`` (and its ``[MoE]`` usage
lines), one full-graph pretrain step, the evaluation runner, and the CLIs.

JAX draws the router's Gumbel noise with ``jax.random.gumbel`` from the
keys its loops split (``encoder_apply``: ``rng, k_drop, k_gumbel =
split(rng, 3)`` a layer); the tests draw the same and hand them to the
port (``Encoder.forward(gumbel=...)``, or in sequence through
``nn.encoder.gumbel_noise`` inside the port's loops), with dropout 0.
Tolerances: f32 losses and forwards 1e-5, gradients within 1e-4 of the
largest, bf16 within 2% of the largest, accuracies within one item.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import sys
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.eval import buckets as jb
from stemgnn_tpu.eval import runner as jr
from stemgnn_tpu.models import pretrain as jax_pre
from stemgnn_tpu.models import task as jax_task
from stemgnn_tpu.nn import convs as jconvs
from stemgnn_tpu.nn import encoder as jenc
from stemgnn_tpu.nn.encoder import encoder_init
from stemgnn_tpu.train import augment as jax_augment
from stemgnn_tpu.train import finetune_loop as jax_ft
from stemgnn_tpu.train import pretrain_loop as jax_loop
from stemgnn_tpu.train.optim import make_optimizer as jax_optimizer
from stemgnn_tpu.vq import vq_init
from stemgnn_tpu_torch import finetune as port_finetune_cli
from stemgnn_tpu_torch import infer as port_infer_cli
from stemgnn_tpu_torch import pretrain as port_pretrain_cli
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.eval import runner as pr
from stemgnn_tpu_torch.nn import convs as pconvs
from stemgnn_tpu_torch.nn import encoder as port_enc
from stemgnn_tpu_torch.train import finetune_loop as port_ft
from stemgnn_tpu_torch.train import pretrain_loop as port_loop
from stemgnn_tpu_torch.train.graph_setup import fused_full_graph
from stemgnn_tpu_torch.utils.convert import (_load, pretrain_from_jax,
                                             pretrain_to_jax,
                                             task_model_from_jax,
                                             task_model_to_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, K, LAMDA = 16, 3, 0.1
FWD = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _t(a):
    return torch.from_numpy(np.array(a))


def layer_gumbels(rng, flags, n, k=K):
    """The Gumbel draws of JAX's ``encoder_apply`` from ``rng``: one [n, k]
    array an MoE layer."""
    out = []
    for flag in flags:
        rng, _, k_gumbel = jax.random.split(rng, 3)
        if flag:
            out.append(np.asarray(jax.random.gumbel(k_gumbel, (n, k),
                                                    jnp.float32)))
    return out


def loop_gumbels(seed, epochs, flags, n):
    """The draws of JAX's per-epoch loops (``_run_node_like``,
    ``train_node_with_buckets``): ``key = PRNGKey(seed)``, one split for
    the init, then one a step."""
    key, _ = jax.random.split(jax.random.PRNGKey(seed))
    out = []
    for _ in range(epochs):
        key, k_step = jax.random.split(key)
        out.extend(layer_gumbels(k_step, flags, n))
    return out


def hand_over(monkeypatch, draws):
    """The port's loops draw their Gumbel noise through
    ``nn.encoder.gumbel_noise``: hand them ``draws`` in order."""
    queue = list(draws)

    def next_draw(shape, generator=None, device=None):
        g = queue.pop(0)
        assert tuple(shape) == g.shape
        return torch.from_numpy(g)
    monkeypatch.setattr(port_enc, "gumbel_noise", next_draw)
    return queue


def _check_grads(got: dict, want: dict, rel=1e-4):
    scale = max(float(np.abs(v).max()) for v in want.values())
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=rel * scale,
                                   err_msg=k)


def _graph(seed=0, n=64, e=400):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 50, e).astype(np.int32)
    r = rng.integers(0, 50, e).astype(np.int32)
    s[:60] = 7
    em = np.arange(e) < e - 40
    nm = np.arange(n) < 50
    x = rng.standard_normal((n, D)).astype(np.float32)
    return x, s, r, em, nm


def _enc_cfgs(moe_layers):
    jc = jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                            moe=True, moe_layers=moe_layers, num_experts=K,
                            dropout=0.0, tau=0.7)
    return jc, pcfg.from_dict(pcfg.EncoderConfig(), vars(jc).copy())


# ------------------------------------------------------------ encoder

@pytest.mark.parametrize("moe_layers", ["last", "all"])
def test_moe_encoder_with_jax_gumbel_draws_matches_jax(moe_layers):
    """The encoder in training (dropout 0, tau 0.7) with JAX's Gumbel draws:
    ``z`` and ``env_reg`` to 1e-5, each MoE layer's router statistics over
    the node mask, the BatchNorm statistics, and the gradients of
    ``sum(z * w) + 0.1 * env_reg`` with respect to every parameter within
    1e-4 of the largest."""
    x, s, r, em, nm = _graph()
    jc, pc = _enc_cfgs(moe_layers)
    p, st = _np(encoder_init(jax.random.PRNGKey(1), jc))
    key = jax.random.PRNGKey(4)
    w = np.random.default_rng(2).standard_normal((x.shape[0], D)).astype(
        np.float32)

    def f(pj):
        z, ns, aux = jenc.encoder_apply(
            pj, st, jc, jnp.asarray(x), jnp.asarray(s), jnp.asarray(r),
            edge_mask=jnp.asarray(em), node_mask=jnp.asarray(nm),
            training=True, rng=key)
        return jnp.sum(z * w) + LAMDA * aux["env_reg"], (z, ns, aux)
    (_, (z_j, st_j, aux_j)), g_j = jax.value_and_grad(f, has_aux=True)(p)
    enc = _load(port_enc.Encoder(pc), p, st).train()
    gumbel = [_t(g) for g in layer_gumbels(key, jc.moe_layer_flags(),
                                           x.shape[0])]
    z_p, aux_p = enc(_t(x), _t(s).long(), _t(r).long(), edge_mask=_t(em),
                     node_mask=_t(nm), gumbel=gumbel, return_aux=True)
    ((z_p * _t(w)).sum() + LAMDA * aux_p["env_reg"]).backward()
    np.testing.assert_allclose(z_p.detach().numpy(), np.asarray(z_j), **FWD)
    assert float(aux_j["env_reg"]) < 0
    np.testing.assert_allclose(float(aux_p["env_reg"]),
                               float(aux_j["env_reg"]), **FWD)
    assert len(aux_p["moe_stats"]) == len(aux_j["moe_stats"]) == len(gumbel)
    for a, b in zip(aux_p["moe_stats"], aux_j["moe_stats"]):
        assert a["layer"] == b["layer"]
        assert int(a["count"]) == int(b["count"]) == 50
        for k in ("sum_prob", "sum_top1"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), **FWD)
    for i, ns in enumerate(st_j["norms"]):
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(enc.norms[i], k).numpy(),
                                       np.asarray(ns[k]), **FWD)
    got = {k: v.grad.numpy() for k, v in enc.named_parameters()}
    want = {k.replace("[", ".").replace("]", "").replace("'", "").lstrip(
        "."): v for k, v in _leaves(g_j).items()}
    _check_grads(got, want)


def test_moe_router_draws_from_the_generator_and_evaluates_by_softmax():
    """Without handed noise the router draws its Gumbel noise from the
    generator (the same seed, the same ``z``; another seed, another);
    in evaluation the weights are the softmax and ``env_reg`` is 0."""
    x, s, r, em, nm = _graph()
    _, pc = _enc_cfgs("last")
    enc = port_enc.Encoder(pc, generator=torch.Generator().manual_seed(0))
    args = (_t(x), _t(s).long(), _t(r).long())
    kw = dict(edge_mask=_t(em), node_mask=_t(nm), return_aux=True)

    def run(seed):
        return enc(*args, generator=torch.Generator().manual_seed(seed),
                   **kw)[0].detach()
    enc.train()
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    enc.eval()
    z, aux = enc(*args, **kw)
    assert float(aux["env_reg"]) == 0.0
    logits = enc.env_encoders[0](torch.relu(enc.norms[0](enc.layers[0](
        args[0], *args[1:], edge_mask=_t(em)))))
    np.testing.assert_allclose(aux["moe_stats"][0]["sum_prob"].numpy(),
                               torch.softmax(logits, -1)[:50].sum(0)
                               .detach().numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ bf16 layer

def test_bf16_moe_layer_at_a_sender_of_more_than_256_out_edges():
    """The MoE layer in bf16 (x bf16, the experts cast) at a sender with
    300 out-edges: its mean divides the sum by JAX's stalled bf16 count,
    256 (ROADMAP, known behaviours), so the hub's aggregate reads 300/256
    of the f32 mean in both packages; the expert outputs within 2% of the
    largest of JAX's bf16 ones, and the gradient with respect to x within
    2% of the largest of JAX's f32 one."""
    rng = np.random.default_rng(3)
    n = 512
    s = np.concatenate([np.full(300, 5), rng.integers(0, n, 700)]).astype(
        np.int32)
    r = np.concatenate([rng.integers(0, n, 300),
                        rng.integers(0, n, 700)]).astype(np.int32)
    r[s == r] = (r[s == r] + 1) % n
    em = np.ones(s.shape[0], bool)
    x = (rng.standard_normal((n, D)) + 1.0).astype(np.float32)
    p = _np(jconvs.moe_sage_init(jax.random.PRNGKey(0), D, D, K))
    w = rng.standard_normal((n, K, D)).astype(np.float32)

    def f(xj, dt):
        out = jconvs.moe_sage_apply(p, xj.astype(dt), jnp.asarray(s),
                                    jnp.asarray(r), edge_mask=jnp.asarray(em))
        return jnp.sum(out.astype(jnp.float32) * w), out
    (_, out_j), gx_j = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x), jnp.bfloat16)
    _, gx_f32 = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x),
                                                    jnp.float32)
    mod = _load(pconvs.MoESAGEConv(D, D, K), p, {})
    xt = _t(x).requires_grad_(True)
    out_p = mod(xt.to(torch.bfloat16), _t(s).long(), _t(r).long(),
                edge_mask=_t(em))
    assert out_p.dtype == torch.bfloat16
    (out_p.float() * _t(w)).sum().backward()
    out_j = np.asarray(out_j.astype(jnp.float32))
    top = np.abs(out_j).max()
    assert np.abs(out_p.detach().float().numpy() - out_j).max() <= 2e-2 * top
    _check_grads({"x": xt.grad.numpy()}, {"x": np.asarray(gx_f32)}, rel=2e-2)
    _check_grads({"x": np.asarray(gx_j.astype(jnp.float32))},
                 {"x": np.asarray(gx_f32)}, rel=3e-2)
    # the hub's stalled count, in both packages
    mean_f32 = x[r[s == 5]].mean(0)
    agg_p = pconvs.reverse_mean(_t(x).to(torch.bfloat16), _t(s).long(),
                                _t(r).long(), _t(em))[5].float().numpy()
    from stemgnn_tpu.ops.spmm import gather_scatter_aggregate as jax_gsa
    agg_j = np.asarray(jax_gsa(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(r), jnp.asarray(s),
        edge_mask=jnp.asarray(em), num_nodes=n, reduce="mean",
        relu=False)[5].astype(jnp.float32))
    for agg in (agg_p, agg_j):
        np.testing.assert_allclose(agg, mean_f32 * 300 / 256, rtol=2e-2,
                                   atol=2e-2)


# ------------------------------------------------------------ finetune

def _ft_cfg(task, num_classes, **kw):
    jc, _ = _enc_cfgs("last")
    base = dict(
        encoder=dataclasses.replace(jc, tau=1.0),
        vq=jcfg.VQConfig(dim=D, codebook_size=16, codebook_dim=D, heads=2,
                         commitment_weight=0.25),
        task=task, num_classes=num_classes, epochs=3, early_stop=100,
        lr=1e-3, repeat=1, epoch_chunk=0, lamda_env=LAMDA)
    base.update(kw)
    return jcfg.FinetuneConfig(**base)


def _port_ft_cfg(cfg):
    fields = {f.name for f in dataclasses.fields(pcfg.FinetuneConfig)}
    return pcfg.from_dict(pcfg.FinetuneConfig(), {
        "encoder": vars(cfg.encoder).copy(), "vq": vars(cfg.vq).copy(),
        **{k: v for k, v in vars(cfg).items()
           if k in fields and k not in ("encoder", "vq")}})


def _datasets(task):
    if task == "node":
        kw = dict(num_nodes=400, num_classes=5, feat_dim=D, avg_degree=6,
                  num_splits=1, train_per_split=200, val_per_split=100,
                  seed=3)
        return (jax_synthetic.synthetic_node_dataset(**kw),
                port_synthetic.synthetic_node_dataset(**kw))
    kw = dict(num_entities=300, num_edges=1500, feat_dim=D, seed=3)
    return (jax_synthetic.synthetic_link_dataset(**kw),
            port_synthetic.synthetic_link_dataset(**kw))


def _bundle(cfg):
    ke, kv = jax.random.split(jax.random.PRNGKey(5))
    ep, es = encoder_init(ke, cfg.encoder)
    vp, vs = vq_init(kv, cfg.vq)
    return _np({"encoder_params": ep, "encoder_state": es, "vq_params": vp,
                "vq_state": dict(vs, initted=np.asarray(True))})


def _initial(cfg, bundle, seed=0):
    _, k_init = jax.random.split(jax.random.PRNGKey(seed))
    return _np(jax_task.task_model_init(
        k_init, cfg, encoder_params=bundle["encoder_params"],
        vq_params=bundle["vq_params"], encoder_state=bundle["encoder_state"],
        vq_state=bundle["vq_state"]))


@pytest.mark.parametrize("task", ["node", "link"])
def test_moe_finetune_step_gradients_match_jax(task):
    """One full-batch finetune step with ``lamda_env`` 0.1 (JAX
    ``_make_node_steps`` + optax, its gradients recorded before AdamW):
    the loss parts to 1e-5 (``env_loss`` the scaled term, negative, as JAX
    logs it), the gradients the optimizer is handed within 1e-4 of the
    largest, and the updated parameters to 1e-5 (the BatchNorm-fed
    ``lin_l`` bias to 2.1 * lr)."""
    ds_j, ds_p = _datasets(task)
    cfg = _ft_cfg(task, ds_p.num_classes)
    params, state = _initial(cfg, _bundle(cfg))
    graph = ds_j.to_graph()
    n_rows = graph.num_nodes_padded if task == "node" else \
        graph.num_edges_padded
    n_items = ds_j.num_nodes if task == "node" else ds_j.num_edges
    y = np.zeros(n_rows, np.int64)
    y[:n_items] = ds_j.labels
    mask = np.zeros(n_rows, bool)
    mask[:n_items] = ds_j.splits[0]["train"]
    grads = []
    tx = optax.chain(optax.GradientTransformation(
        lambda p: optax.EmptyState(),
        lambda g, s, p=None: (grads.append(g) or g, s)),
        optax.adamw(cfg.lr, weight_decay=0.01))
    trainable, frozen = jax_ft._split_params(params, cfg)
    key = jax.random.PRNGKey(0)
    new_j, _, _, losses_j, stats_j = jax_ft._make_node_steps(cfg, task)[0](
        trainable, frozen, tx.init(trainable), state, key,
        jnp.asarray(mask), graph, jnp.asarray(y.astype(np.int32)), tx)

    pc = _port_ft_cfg(cfg)
    model = task_model_from_jax(params, state, pc)
    g_p = fused_full_graph(ds_p, pc, device="cpu")
    loss_fn, _, _ = port_ft._make_node_steps(pc, task)
    trainable_p, _ = port_ft._split_params(model, pc)
    opt = port_ft.make_optimizer(trainable_p, pc)
    gumbel = [_t(g) for g in layer_gumbels(
        key, cfg.encoder.moe_layer_flags(), g_p.num_nodes_padded)]
    _, parts = loss_fn(model, _t(mask), g_p, _t(y), gumbel=gumbel)
    stats_p = parts.pop("moe_stats")
    port_ft._apply(opt, parts["loss"])
    assert float(losses_j["env_loss"]) < 0
    for k, v in losses_j.items():
        np.testing.assert_allclose(float(parts[k]), float(v), err_msg=k,
                                   **FWD)
    np.testing.assert_allclose(
        float(parts["env_loss"]),
        float(parts["loss"] - parts["act_loss"] - parts["jac_loss"]),
        rtol=1e-6)
    for a, b in zip(stats_p, stats_j):
        np.testing.assert_allclose(a["sum_prob"].numpy(),
                                   np.asarray(b["sum_prob"]), **FWD)
    want = _leaves({k: grads[0][k] for k in ("encoder", "decoder")})
    got_model = task_model_to_jax(_grad_model(model))[0]
    got = _leaves({k: got_model[k] for k in ("encoder", "decoder")})
    _check_grads(got, want)
    new_p = _leaves({k: task_model_to_jax(model)[0][k]
                     for k in ("encoder", "decoder")})
    for path, leaf in _leaves({k: new_j[k] for k in ("encoder",
                                                     "decoder")}).items():
        noise = "lin_l" in path and "'b'" in path
        np.testing.assert_allclose(new_p[path], leaf, err_msg=path,
                                   **(dict(rtol=0, atol=2.1 * cfg.lr)
                                      if noise else FWD))


def _grad_model(model):
    """A copy of ``model`` holding its gradients as its values (zeros where
    a frozen parameter has none)."""
    import copy
    gm = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(gm.parameters(), model.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    return gm


def test_moe_run_finetune_matches_jax(monkeypatch, capsys):
    """3 full-batch epochs of ``run_finetune`` with ``--moe --moe_layers
    last --lamda_env 0.1`` from JAX's initial model and with JAX's Gumbel
    draws: every epoch's loss parts to 1e-5 (``env_loss`` the scaled
    term), the accuracies within one item, and the same ``[MoE]`` usage
    lines, one a layer every ``max(1, epochs // 20)`` epochs."""
    ds_j, ds_p = _datasets("node")
    cfg = _ft_cfg("node", ds_p.num_classes)
    logged = []

    class Recorder(jax_ft.Logger):
        def log(self, run, epoch, loss, result):
            logged.append((dict(loss), dict(result)))
            return super().log(run, epoch, loss, result)
    monkeypatch.setattr(jax_ft, "Logger", Recorder)
    bundle = _bundle(cfg)
    jax_ft.run_finetune(ds_j, cfg, pretrained=bundle)
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("[MoE]")]
    pc = _port_ft_cfg(cfg)
    init = _initial(cfg, bundle)
    monkeypatch.setattr(port_ft, "task_model_init",
                        lambda *a, **k: task_model_from_jax(*init, pc))
    n_pad = ds_p.to_graph().num_nodes_padded
    queue = hand_over(monkeypatch, loop_gumbels(
        0, cfg.epochs, cfg.encoder.moe_layer_flags(), n_pad))
    res = port_ft.run_finetune(ds_p, pc, device="cpu")
    assert not queue
    port_lines = [ln for ln in capsys.readouterr().out.splitlines()
                  if ln.startswith("[MoE]")]
    assert len(port_lines) == len(jax_lines) == cfg.epochs
    for a, b in zip(port_lines, jax_lines):
        va = [float(v) for v in a.replace("[", " ").replace("]", " ")
              .replace(",", " ").split()[3:] if v[0].isdigit()]
        vb = [float(v) for v in b.replace("[", " ").replace("]", " ")
              .replace(",", " ").split()[3:] if v[0].isdigit()]
        assert a.split()[:3] == b.split()[:3]
        np.testing.assert_allclose(va, vb, rtol=0, atol=1.5e-3)
    got = res["logger"].data[0]
    masks = ds_p.splits[0]
    assert len(logged) == len(res["epoch_losses"]) == len(got["val"]) \
        == cfg.epochs
    for e, (loss_j, acc_j) in enumerate(logged):
        assert loss_j["env_loss"] < 0
        for k in ("loss", "act_loss", "jac_loss", "env_loss"):
            np.testing.assert_allclose(res["epoch_losses"][e][k], loss_j[k],
                                       err_msg=f"epoch {e} {k}", **FWD)
        for k, split in (("train", "train"), ("val", "valid"),
                         ("test", "test")):
            size = int(np.asarray(masks[split]).sum())
            assert abs(got[k][e] - acc_j[k]) <= 100.0 / size + 1e-9, (e, k)


# ------------------------------------------------------------ pretrain

N_PRE = 512


def _pre_cfg():
    jc, _ = _enc_cfgs("last")
    return jcfg.PretrainConfig(
        encoder=dataclasses.replace(jc, normalize="batch"),
        vq=jcfg.VQConfig(dim=D, codebook_size=32, codebook_dim=D, heads=2),
        batch_size=0, lamda_env=LAMDA)


def _pre_dataset(pkg):
    return pkg.synthetic_node_dataset(num_nodes=N_PRE, num_classes=5,
                                      feat_dim=D, avg_degree=8,
                                      pref_attach=1.1, num_splits=1, seed=3)


def _pre_draws(cfg, g, rng):
    """Every draw of JAX's step from ``rng`` (pretrain_loop.py:64-67,
    models/pretrain.py:113, 138-148, vq/quantize.py:197, 138; the
    student's Gumbel noise from ``k_enc``, the teacher's from
    ``k_teacher``)."""
    k_feat, k_edge, k_fwd = jax.random.split(rng, 3)
    k_enc, k_vq, k_topo, k_neg, _, k_teacher = jax.random.split(k_fwd, 6)
    num = max(int(g.num_edges_padded * cfg.topo_recon_ratio), 1)
    slots, _ = jax_pre._sample_edge_slots(k_topo, g.edge_mask, num)
    neg = jax_pre._negative_edges(k_neg, num, g.n_node, g.num_nodes_padded)
    _, k_ortho, _ = jax.random.split(k_vq, 3)
    keep = jax.random.bernoulli(k_feat, 1.0 - cfg.feat_p, (D,))
    flags = cfg.encoder.moe_layer_flags()
    n = g.num_nodes_padded

    def t(a):
        return torch.from_numpy(np.array(a)).long()
    return dict(
        feat_keep=torch.from_numpy(np.array(keep)),
        drop_seed=t(jax_augment.dropout_edge_seed(k_edge)),
        slots=t(slots), neg=(t(neg[0]), t(neg[1])),
        ortho_ids=t(jax.random.permutation(
            k_ortho, cfg.vq.codebook_size)[:cfg.vq.orthogonal_reg_max_codes]),
        gumbel=[_t(g) for g in layer_gumbels(k_enc, flags, n)],
        teacher_gumbel=[_t(g) for g in layer_gumbels(k_teacher, flags, n)])


@pytest.mark.parametrize("route", ["plain_f32", "layout_bf16"])
def test_moe_pretrain_step_matches_jax(route):
    """One full-graph pretrain step (``make_pretrain_step``) with an MoE
    last layer, ``lamda_env`` 0.1 and the pair-hash edge dropout at 0.2,
    against JAX's ``make_pretrain_step`` + optax with every draw handed
    over (the Gumbel noise of the student and of the teacher too): the
    losses (``env_reg_loss`` negative), the clipped gradients and the
    updated parameters and teacher.  ``plain_f32``: losses to 1e-5,
    gradients within 1e-4 of the largest, parameters to 1e-5.
    ``layout_bf16``: the first layer on the hub layout under ``drop_hash``
    with bf16 messages while the MoE layer reads the materialized keep
    mask; losses 3e-2, gradients within 2% of the largest, parameters 2.1
    * lr (AdamW's first step)."""
    cfg = _pre_cfg()
    params, teacher, state = _np(jax_pre.pretrain_init(
        jax.random.PRNGKey(0), cfg))
    noise = np.random.default_rng(1)
    teacher = jax.tree_util.tree_map(
        lambda a: (a + noise.normal(0.0, 0.1, a.shape)).astype(a.dtype),
        teacher)
    g_j = _pre_dataset(jax_synthetic).to_graph()
    grads = []

    def record(g, s, p=None):          # the step is jitted: a callback
        jax.debug.callback(lambda t: grads.append(t), g)
        return g, s
    tx = optax.chain(optax.GradientTransformation(
        lambda p: optax.EmptyState(), record),
        jax_optimizer(cfg.lr, cfg.weight_decay, grad_clip=cfg.grad_clip,
                      use_scheduler=cfg.use_scheduler, epochs=cfg.epochs,
                      steps_per_epoch=1))
    rng = jax.random.PRNGKey(5)
    p_j, t_j, _, _, m_j = jax_loop.make_pretrain_step(cfg, tx, bs=N_PRE)(
        params, teacher, tx.init(params), state, g_j, rng)
    draws = _pre_draws(cfg, g_j, rng)
    grads_j = _leaves(_np(optax.clip_by_global_norm(cfg.grad_clip).update(
        grads[0], optax.EmptyState())[0]))

    pc = pcfg.from_dict(pcfg.PretrainConfig(), {
        "encoder": vars(cfg.encoder).copy(), "vq": vars(cfg.vq).copy(),
        "batch_size": 0, "lamda_env": LAMDA})
    model, teach = pretrain_from_jax(params, teacher, state, pc)
    ds_p = _pre_dataset(port_synthetic)
    if route == "layout_bf16":
        g_p = fused_full_graph(ds_p, pcfg.FinetuneConfig(
            encoder=pc.encoder, hub_size=64, sc_hub_size=64), device="cpu",
            use_layout=True)
        assert g_p.layout.hub_r is not None
    else:
        g_p = port_loop.pretrain_graph(ds_p, pc, device="cpu")
        assert g_p.layout is None
    got = port_loop.make_pretrain_step(pc, bs=N_PRE)(
        model, teach, port_loop.make_pretrain_optimizer(model, pc), g_p,
        draws)
    f32 = route == "plain_f32"
    tol = FWD if f32 else dict(rtol=3e-2, atol=3e-2)
    assert float(m_j["env_reg_loss"]) < 0
    for k, v in m_j.items():
        np.testing.assert_allclose(float(got[k]), float(v), err_msg=k, **tol)
    gm = _grad_model(model)
    _check_grads(_leaves(pretrain_to_jax(gm, teach)[0]), grads_j,
                 rel=1e-4 if f32 else 2e-2)
    p_p, t_p, _ = pretrain_to_jax(model, teach)
    sign_tol = dict(rtol=0, atol=2.1 * cfg.lr)
    for tree_p, tree_j in ((p_p, _np(p_j)), (t_p, _np(t_j))):
        lp, lj = _leaves(tree_p), _leaves(tree_j)
        assert set(lp) == set(lj)
        for path, leaf in lj.items():
            noise = "lin_l" in path and "'b'" in path
            np.testing.assert_allclose(
                lp[path], leaf, err_msg=path,
                **(tol if f32 and not noise else sign_tol))


# ------------------------------------------------------------ runner

def test_runner_with_moe_matches_jax(monkeypatch):
    """``train_node_with_buckets`` with ``--moe --lamda_env 0.1`` (the env
    term in its train step, JAX eval/runner.py:80) from JAX's initial
    weights and with JAX's Gumbel draws: the same best epoch, every split's
    and bucket's accuracy within one node, and the best snapshot's encoder
    and decoder to 1e-5."""
    seed = 2
    cfg = _ft_cfg("node", 5, epochs=4, encoder=dataclasses.replace(
        _enc_cfgs("last")[0], normalize="none"))
    ds_j, ds_p = _datasets("node")
    _, _, buckets = jb.compute_degree_buckets(ds_j.edge_index, ds_j.num_nodes)
    tr, va, te = jb.stratified_split(buckets["ID"], ds_j.labels, seed=seed)
    split = {"train": tr, "valid": va, "test": te}
    bundle = _bundle(cfg)
    want = jr.train_node_with_buckets(ds_j, cfg, split, buckets,
                                      pretrained=bundle, seed=seed)
    pc = _port_ft_cfg(cfg)
    model = task_model_from_jax(*_initial(cfg, bundle, seed), pc)
    n_pad = ds_p.to_graph().num_nodes_padded
    queue = hand_over(monkeypatch, loop_gumbels(
        seed, cfg.epochs, cfg.encoder.moe_layer_flags(), n_pad))
    best = pr.train_node_with_buckets(ds_p, pc, split, buckets, seed=seed,
                                      device="cpu", use_layout=False,
                                      model=model)
    assert not queue
    assert best["epoch"] == want["epoch"]
    for part in ("split_acc", "bucket_acc"):
        masks = split if part == "split_acc" else buckets
        for k, w in want[part].items():
            m = np.asarray(masks[k])
            size = int(m.sum()) if m.dtype == bool else m.size
            assert abs(best[part][k] - w) <= 100.0 / size + 1e-9, (part, k)
    got_p, _ = task_model_to_jax(pr.snapshot_model(best))
    want_p = _np(jax_ft._merge(want["trainable"], want["frozen"]))
    for part in ("encoder", "decoder"):
        lg, lw = _leaves(got_p[part]), _leaves(want_p[part])
        assert set(lg) == set(lw)
        for path, leaf in lw.items():
            np.testing.assert_allclose(lg[path], leaf, err_msg=path, **FWD)


# ------------------------------------------------------------ CLIs

def _load_jax_infer():
    spec = importlib.util.spec_from_file_location(
        "repo_infer", os.path.join(ROOT, "infer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_moe_clis_on_the_cpu(monkeypatch, capsys):
    """The CLI chain with ``--moe --moe_layers last --lamda_env 0.1`` on
    the CPU: ``pretrain`` (2 steps; ``env_reg_loss`` in the history,
    negative; ``config.json`` records the MoE encoder), ``finetune`` from
    that checkpoint (the MoE architecture adopted from ``config.json``,
    ``[MoE]`` usage lines, the scaled ``env_loss``), and ``infer --mode
    encode``, which adopts only ``hidden_dim``, ``num_layers``,
    ``backbone`` and ``normalize`` from ``config.json`` as the repo's
    infer.py does, so that on an MoE checkpoint both packages fail to load
    the weights alike."""
    run_id = f"test_moe_{uuid.uuid4().hex[:8]}"
    root = os.path.join(ROOT, "ckpts", "pretrain_model", run_id)
    moe = ["--moe", "--moe_layers", "last", "--lamda_env", str(LAMDA)]
    small = ["--feat_dim", str(D), "--hidden_dim", str(D), "--code_dim",
             str(D), "--codebook_size", "16", "--device", "cpu"]
    try:
        model, _, hist, _ = port_pretrain_cli.main(
            ["--pretrain_dataset", "cora_synthetic", "--pretrain_batch_size",
             "512", "--epochs", "1", "--max_steps", "2", "--pretrain_run_id",
             run_id, *moe, *small])
        assert len(model.encoder.env_encoders) == 1
        assert hist[0]["env_reg_loss"] < 0
        with open(os.path.join(root, "config.json")) as f:
            saved = json.load(f)
        assert saved["encoder"]["moe"] and \
            saved["encoder"]["moe_layers"] == "last"
        assert saved["pretrain"]["lamda_env"] == LAMDA
        capsys.readouterr()
        res = port_finetune_cli.main(
            ["--finetune_dataset", "cora_synthetic", "--pretrain_path", root,
             "--pretrain_model_epoch", "1", "--epochs", "2", "--repeat", "1",
             "--debug", "--lamda_env", str(LAMDA), *small])
        out = capsys.readouterr().out
        assert "Adopted architecture hyperparams from config.json" in out
        assert sum(ln.startswith("[MoE] Layer 1 avg_prob=[")
                   for ln in out.splitlines()) == 2
        assert res["cfg"].encoder.moe_layer_flags() == (False, True)
        assert all(e["env_loss"] < 0 for e in res["epoch_losses"])
        common = ["--finetune_dataset", "cora_synthetic", "--feat_dim",
                  str(D), "--pretrain_path", root, "--pretrain_model_epoch",
                  "1", "--out", os.path.join(root, "enc.npz")]
        with pytest.raises(RuntimeError, match="env_encoders|weights"):
            port_infer_cli.main([*common, "--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["infer.py", *common])
        with pytest.raises(KeyError):
            _load_jax_infer().main()
    finally:
        shutil.rmtree(root, ignore_errors=True)
