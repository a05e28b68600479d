"""The port's gcn, gin and gat backbones, the MoE-SAGE layer and the
modules around them against the JAX package on the CPU:
``segment_softmax``, each conv's forward and gradients, the encoder of
every backbone in evaluation and in training (dropout 0), ``layerwise_
encode`` of every backbone over 4 edge blocks, the inner-product decoders
(``inner_product_decode_all`` and the masked / raw ``edge_inner_product``),
the reference-checkpoint importer against JAX's ``import_encoder`` /
``import_pretrain_model`` on random ``state_dict``s, and each backbone's
``--save_model`` file through both packages' ``infer --mode predict``.

The MoE router's Gumbel noise in training, the bf16 MoE layer and the MoE
finetune and pretrain steps are in ``test_torch_port_moe.py``.
Tolerances: f32 forwards 1e-5; gradients within 1e-4 of the largest.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.models import task as jax_task
from stemgnn_tpu.nn import convs as jconvs
from stemgnn_tpu.nn import encoder as jenc
from stemgnn_tpu.nn.decoders import (inner_product_decode_all,
                                     inner_product_decoder_init)
from stemgnn_tpu.ops import segment as jseg
from stemgnn_tpu.ops.sddmm import edge_inner_product as jax_eip
from stemgnn_tpu.train import finetune_loop as jax_ft
from stemgnn_tpu.train import infer as jax_infer
from stemgnn_tpu.utils import torch_import as jax_import
from stemgnn_tpu_torch import infer as port_infer_cli
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.nn import convs as pconvs
from stemgnn_tpu_torch.nn.decoders import (InnerProductDecoder,
                                           edge_inner_product)
from stemgnn_tpu_torch.nn.encoder import Encoder
from stemgnn_tpu_torch.ops import segment as pseg
from stemgnn_tpu_torch.train import finetune_loop as port_ft
from stemgnn_tpu_torch.train import infer as port_infer
from stemgnn_tpu_torch.utils import torch_import as port_import
from stemgnn_tpu_torch.utils.convert import (_load, _module_trees,
                                             pretrain_to_jax,
                                             task_model_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N, E = 16, 64, 400
FWD = dict(rtol=1e-5, atol=1e-5)
K = 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _graph(seed=0):
    """A padded graph: 50 real nodes of 64, 360 valid edges of 400, a hub
    of 60 in- and out-edges, node 3 with no in-edge and node 4 with no
    out-edge."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 50, E).astype(np.int32)
    r = rng.integers(0, 50, E).astype(np.int32)
    s[:60], r[60:120] = 7, 7
    r[r == 3] = 5
    s[s == 4] = 6
    em = np.arange(E) < 360
    nm = np.arange(N) < 50
    x = rng.standard_normal((N, D)).astype(np.float32)
    return x, s, r, em, nm


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_grads(got: dict, want: dict):
    """Every gradient within 1e-4 of the largest of JAX's."""
    scale = max(float(np.abs(v).max()) for v in want.values())
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)


# ------------------------------------------------------------ segment

@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_matches_jax(masked):
    """Values and d/dlogits of sum(out * w): masked entries 0, a segment
    with every entry masked and an empty segment, logits of both signs."""
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 10, 200).astype(np.int32)
    ids[ids == 9] = 8                       # segment 9 empty
    logits = (rng.standard_normal(200) * 5).astype(np.float32)
    mask = (rng.random(200) < 0.8) | (not masked)
    mask[ids == 2] = not masked             # segment 2 all masked
    w = rng.standard_normal(200).astype(np.float32)
    m_j = jnp.asarray(mask) if masked else None

    def f(lg):
        out = jseg.segment_softmax(lg, jnp.asarray(ids), 10, mask=m_j)
        return jnp.sum(out * w), out
    (_, out_j), g_j = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(logits))
    lg = _t(logits).requires_grad_(True)
    out_p = pseg.segment_softmax(lg, _t(ids), 10,
                                 mask=_t(mask) if masked else None)
    (out_p * _t(w)).sum().backward()
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j),
                               **FWD)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-6)
    if masked:
        assert not out_p[_t(~mask)].any()


# ------------------------------------------------------------ convs

def _conv_pair(kind, key):
    """(JAX init, JAX apply, port module) of one conv, D -> D."""
    if kind == "moe":
        p = jconvs.moe_sage_init(key, D, D, K)
        return p, jconvs.moe_sage_apply, pconvs.MoESAGEConv(D, D, K)
    init, apply, mod = {
        "gcn": (jconvs.gcn_init, jconvs.gcn_apply, pconvs.GCNConv),
        "gin": (jconvs.gin_init, jconvs.gin_apply, pconvs.GINConv),
        "gat": (jconvs.gat_init, jconvs.gat_apply, pconvs.GATConv)}[kind]
    return init(key, D, D), apply, mod(D, D)


@pytest.mark.parametrize("kind", ["moe", "gcn", "gin", "gat"])
def test_conv_forward_and_grads_match_jax(kind):
    """Each conv's output and the gradients of sum(out * w) with respect
    to x and every parameter (the MoE layer's [N, K, out] expert outputs:
    the receivers' mean at each sender, the residual; gcn's self-loop on
    every row; gin's trainable eps; gat's one-head attention)."""
    x, s, r, em, nm = _graph()
    p, apply, mod = _conv_pair(kind, jax.random.PRNGKey(2))
    p = _np(p)
    if kind == "gin":
        p["eps"] = np.asarray(0.3, np.float32)
    if kind in ("gcn", "gat"):
        p["bias"] = np.linspace(-1, 1, D).astype(np.float32)
    _load(mod, p, {})
    out_shape = (N, K, D) if kind == "moe" else (N, D)
    w = np.random.default_rng(3).standard_normal(out_shape).astype(
        np.float32)

    def f(xj, pj):
        kw = {"node_mask": jnp.asarray(nm)} if kind == "gcn" else {}
        out = apply(pj, xj, jnp.asarray(s), jnp.asarray(r),
                    edge_mask=jnp.asarray(em), **kw)
        return jnp.sum(out * w), out
    (_, out_j), (gx_j, gp_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), p)
    xt = _t(x).requires_grad_(True)
    out_p = mod(xt, _t(s).long(), _t(r).long(), edge_mask=_t(em))
    assert out_p.shape == out_shape
    (out_p * _t(w)).sum().backward()
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j),
                               **FWD)
    got = {"x": xt.grad.numpy(), **{
        "p." + k: v.grad.numpy() for k, v in mod.named_parameters()}}
    want = {"x": np.asarray(gx_j), **{
        "p." + k.replace("/", "."): v for k, v in _flat(gp_j).items()}}
    _check_grads(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_segment_sum_in_blocks_matches_one_pass(dtype, monkeypatch):
    """``ops/spmm.gather_segment_sum`` over blocks of 37 edges (11 blocks,
    the last short) against one pass and against autograd through the
    plain gather + ``index_add_``: values and the gradients with respect
    to x and to the per-edge weights (gat's attention), with a mask; bf16
    rows summed in f32 and rounded once, so the blocks change nothing
    there either."""
    from stemgnn_tpu_torch.ops import spmm
    x, s, r, em, _ = _graph()
    dt = getattr(torch, dtype)
    w = np.random.default_rng(4).random(E).astype(np.float32)
    g = np.random.default_rng(5).standard_normal((N, D)).astype(np.float32)
    si, ri = _t(s).long(), _t(r).long()

    def run(weighted, blocked):
        xt = _t(x).to(dt).requires_grad_(True)
        wt = _t(w).requires_grad_(True) if weighted else None
        if blocked is None:                  # autograd's reference
            msg = xt.float()[si] * (1.0 if wt is None else wt[:, None])
            out = torch.zeros(N, D).index_add_(
                0, ri, msg * _t(em)[:, None]).to(dt)
        else:
            if blocked:
                monkeypatch.setattr(spmm, "EDGE_BLOCK", 37)
            out = spmm.gather_segment_sum(xt, si, ri, N, mask=_t(em),
                                          weight=wt)
            monkeypatch.undo()
        (out.float() * _t(g)).sum().backward()
        return [out.detach().float(), xt.grad.float()] + (
            [wt.grad] if weighted else [])
    for weighted in (False, True):
        want = run(weighted, False)
        got = run(weighted, True)
        for a, b in zip(got, want):
            assert torch.equal(a, b) or dtype == "float32"
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-5)
        ref = run(weighted, None)
        tol = 1e-5 if dtype == "float32" else 2e-2
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol,
                                       atol=tol)


def _flat(tree, prefix=""):
    """Nested dicts and lists -> {"a/0/b": array}."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_moe_layer_aggregates_the_receivers_at_each_sender():
    """The MoE layer's mean runs over each node's valid OUT-edges: a node
    with in-edges only aggregates nothing, and a sender averages exactly
    its receivers' rows (not the in-degree mean the usual argument order
    would give)."""
    x, s, r, em, _ = _graph()
    xt = _t(x)
    got = pconvs.reverse_mean(xt, _t(s).long(), _t(r).long(), _t(em))
    for node in (4, 7, 11):
        out = (s == node) & em
        want = x[r[out]].mean(0) if out.any() else np.zeros(D)
        np.testing.assert_allclose(got[node].numpy(), want, **FWD)
    assert not got[4].any()


# ------------------------------------------------------------ encoder

BACKBONES = {"sage": ("sage", "none"), "gcn": ("gcn", "none"),
             "gin": ("gin", "none"), "gat": ("gat", "none"),
             "moe_last": ("sage", "last"), "moe_all": ("sage", "all")}


def _enc_cfgs(name, **kw):
    bb, moe = BACKBONES[name]
    jc = jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                            backbone=bb, moe=moe != "none", moe_layers=moe,
                            num_experts=K, dropout=0.0, **kw)
    return jc, pcfg.from_dict(pcfg.EncoderConfig(), vars(jc).copy())


def _enc_pair(name, seed=1, **kw):
    """JAX's encoder trees (BatchNorm statistics made non-trivial) and the
    port's Encoder holding them."""
    jc, pc = _enc_cfgs(name, **kw)
    p, st = _np(jenc.encoder_init(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    for bn in st["norms"]:
        bn["mean"] = rng.normal(0, 0.1, D).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, D).astype(np.float32)
    return jc, p, st, _load(Encoder(pc), p, st)


@pytest.mark.parametrize("name,training", [
    *((n, t) for n in ("sage", "gcn", "gin", "gat") for t in (False, True)),
    ("moe_last", False), ("moe_all", False)])
def test_encoder_matches_jax(name, training):
    """The whole encoder (2 layers, BatchNorm, relu) in evaluation and in
    training with dropout 0: ``z`` to 1e-5, the BatchNorm statistics
    after the training forward, ``env_reg`` (0 outside training; with an
    MoE layer in training see test_torch_port_moe.py) and the router
    statistics of the evaluation's softmax."""
    x, s, r, em, nm = _graph()
    jc, p, st, enc = _enc_pair(name)
    z_j, st_j, aux_j = jenc.encoder_apply(
        p, st, jc, jnp.asarray(x), jnp.asarray(s), jnp.asarray(r),
        edge_mask=jnp.asarray(em), node_mask=jnp.asarray(nm),
        training=training, rng=jax.random.PRNGKey(4))
    enc.train(training)
    z_p, aux_p = enc(_t(x), _t(s).long(), _t(r).long(), edge_mask=_t(em),
                     node_mask=_t(nm), return_aux=True)
    np.testing.assert_allclose(z_p.detach().numpy(), np.asarray(z_j), **FWD)
    assert float(aux_p["env_reg"]) == float(aux_j["env_reg"]) == 0.0
    assert len(aux_p["moe_stats"]) == len(aux_j["moe_stats"])
    for a, b in zip(aux_p["moe_stats"], aux_j["moe_stats"]):
        assert a["layer"] == b["layer"] and int(a["count"]) == 50
        for k in ("sum_prob", "sum_top1"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), **FWD)
    for i, ns in enumerate(st_j["norms"]):
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(enc.norms[i], k).numpy(),
                                       np.asarray(ns[k]), **FWD)


def test_encoder_refuses_an_unknown_backbone():
    _, pc = _enc_cfgs("sage")
    import dataclasses
    with pytest.raises(ValueError, match="Unsupported backbone"):
        Encoder(dataclasses.replace(pc, backbone="gatv2"))


@pytest.mark.parametrize("bb", ["gcn", "gin", "gat"])
def test_backbone_finetune_step_matches_jax(bb):
    """One full-batch finetune step of each backbone (JAX
    ``_make_node_steps`` + ``optax.adamw``, its gradients recorded before
    AdamW): the loss to 1e-5, the gradients AdamW is handed within 1e-4 of
    the largest, and the updated encoder and decoder to 1e-5 — gin's
    0-dim ``eps`` among them, decayed and moved as optax moves it (the
    convs' BatchNorm-fed biases to 2.1 * lr)."""
    import optax
    ds_kw = dict(num_nodes=300, num_classes=4, feat_dim=D, avg_degree=6,
                 num_splits=1, train_per_split=150, val_per_split=50,
                 seed=2)
    ds_j = jax_synthetic.synthetic_node_dataset(**ds_kw)
    ds_p = port_synthetic.synthetic_node_dataset(**ds_kw)
    jc, pc = _enc_cfgs(bb)
    cfg = jcfg.FinetuneConfig(
        encoder=jc, vq=jcfg.VQConfig(dim=D, codebook_size=8, codebook_dim=D,
                                     heads=2, commitment_weight=0.25),
        task="node", num_classes=4, lr=1e-3)
    params, state = _np(jax_task.task_model_init(jax.random.PRNGKey(3),
                                                 cfg))
    if bb == "gin":
        for layer in params["encoder"]["layers"]:
            layer["eps"] = np.asarray(0.2, np.float32)
    graph = ds_j.to_graph()
    n_pad = graph.num_nodes_padded
    y = np.zeros(n_pad, np.int64)
    y[:ds_j.num_nodes] = ds_j.labels
    mask = np.zeros(n_pad, bool)
    mask[:ds_j.num_nodes] = ds_j.splits[0]["train"]
    grads = []
    tx = optax.chain(optax.GradientTransformation(
        lambda p: optax.EmptyState(),
        lambda g, s, p=None: (grads.append(g) or g, s)),
        optax.adamw(cfg.lr, weight_decay=0.01))
    trainable, frozen = jax_ft._split_params(params, cfg)
    new_j, _, _, losses_j, _ = jax_ft._make_node_steps(cfg, "node")[0](
        trainable, frozen, tx.init(trainable), state, jax.random.PRNGKey(0),
        jnp.asarray(mask), graph, jnp.asarray(y.astype(np.int32)), tx)
    pcf = pcfg.from_dict(pcfg.FinetuneConfig(), {
        "encoder": vars(jc).copy(), "vq": vars(cfg.vq).copy(),
        "task": "node", "num_classes": 4, "lr": cfg.lr})
    model = task_model_from_jax(params, state, pcf)
    g_p = port_ft.fused_full_graph(ds_p, pcf, device="cpu")
    assert g_p.edge_feat is None and g_p.layout is None
    loss_fn, _, _ = port_ft._make_node_steps(pcf)
    opt = port_ft.make_optimizer(port_ft._split_params(model, pcf)[0], pcf)
    _, parts = loss_fn(model, _t(mask), g_p, _t(y))
    port_ft._apply(opt, parts["loss"])
    np.testing.assert_allclose(float(parts["loss"]),
                               float(losses_j["loss"]), **FWD)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()
           if k.startswith(("encoder.", "decoder."))}
    want = {"encoder." + k: v for k, v in _flat(grads[0]["encoder"]).items()}
    want.update({"decoder." + k: v
                 for k, v in _flat(grads[0]["decoder"]).items()})
    want = {k.replace("/", "."): v for k, v in want.items()}
    _check_grads(got, want)
    new_p = {k: p.detach().numpy() for k, p in model.named_parameters()}
    for k, v in {**{"encoder." + a: b for a, b in _flat(
            new_j["encoder"]).items()}, **{"decoder." + a: b for a, b in
                                          _flat(new_j["decoder"]).items()}
                 }.items():
        k = k.replace("/", ".")
        # a conv's bias feeds a BatchNorm: its true gradient is 0, and
        # AdamW turns the float noise into a step of up to lr either way
        # (tests/test_torch_port_train.py's lin_l bias)
        noise = k.startswith("encoder.layers.") and k.endswith(("bias",
                                                                "lin.b"))
        np.testing.assert_allclose(new_p[k], v, err_msg=k, **(
            dict(rtol=0, atol=2.1 * cfg.lr) if noise else FWD))
    if bb == "gin":
        assert float(model.encoder.layers[0].eps) != 0.2


# ------------------------------------------------------------ layer-wise

@pytest.mark.parametrize("name", list(BACKBONES))
def test_layerwise_encode_matches_jax(name):
    """``layerwise_encode`` of every backbone over 4 edge blocks against
    JAX's: ``z`` to 1e-5 and the node mask equal (the MoE layer: the
    streamed reverse sum over the out-degree, the experts one at a time;
    gcn: the host's edge weights; gin: the streamed sum; gat: the two-pass
    online softmax)."""
    rng = np.random.default_rng(5)
    n = 300
    s = rng.integers(0, n, 2000).astype(np.int32)
    r = rng.integers(0, n, 2000).astype(np.int32)
    s[:150] = 9                             # a hub sender and receiver
    r[150:300] = 11
    feat = rng.standard_normal((n, D)).astype(np.float32)
    jc, p, st, enc = _enc_pair(name)
    kw = dict(num_nodes=n, edge_block=500)
    z_j, m_j = jax_infer.layerwise_encode(p, st, jc, feat, s, r, **kw)
    z_p, m_p = port_infer.layerwise_encode(enc, feat, s, r, **kw)
    assert np.array_equal(np.asarray(m_j), m_p.numpy())
    np.testing.assert_allclose(z_p.numpy(), np.asarray(z_j), **FWD)
    # the layer-wise pass is the full graph's eval-mode forward
    enc.eval()
    z_full = enc(_t(np.pad(feat, ((0, z_p.shape[0] - n), (0, 0)))),
                 _t(s).long(), _t(r).long(),
                 node_mask=torch.arange(z_p.shape[0]) < n)
    np.testing.assert_allclose(z_p[:n].numpy(), z_full[:n].detach().numpy(),
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ decoders

@pytest.mark.parametrize("sigmoid", [True, False])
def test_inner_product_decoders_match_jax(sigmoid):
    """``decode_all`` against ``inner_product_decode_all`` (dense N x N),
    and ``edge_inner_product`` with a mask (0.5 under the sigmoid, else 0)
    against ``ops/sddmm.edge_inner_product``."""
    rng = np.random.default_rng(6)
    z = rng.standard_normal((40, D)).astype(np.float32)
    p = _np(inner_product_decoder_init(jax.random.PRNGKey(7), D, D))
    dec = _load(InnerProductDecoder(D, D), p, {})
    want = inner_product_decode_all(p, jnp.asarray(z), sigmoid=sigmoid)
    got = dec.decode_all(_t(z), sigmoid=sigmoid)
    assert got.shape == (40, 40)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    s = rng.integers(0, 40, 100)
    r = rng.integers(0, 40, 100)
    m = rng.random(100) < 0.7
    want = jax_eip(jnp.asarray(z), jnp.asarray(s), jnp.asarray(r),
                   edge_mask=jnp.asarray(m), sigmoid=sigmoid)
    got = edge_inner_product(_t(z), _t(s), _t(r), edge_mask=_t(m),
                             sigmoid=sigmoid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    assert (got[_t(~m)] == (0.5 if sigmoid else 0.0)).all()


# ------------------------------------------------------------ importer

def _ref_encoder_sd(name, rng, prefix=""):
    """A random reference encoder ``state_dict`` (torch layouts: Linear
    weights [out, in], PyG's fixed gin eps a [1] buffer), its weights at
    the scale of a trained model's."""
    bb, moe = BACKBONES[name]
    flags = {"none": (False, False), "last": (False, True),
             "all": (True, True)}[moe]
    sd, env = {}, 0

    def lin(pre, i, o, bias=True):
        # a trained layer's scale: unit-variance outputs
        sd[f"{prefix}{pre}.weight"] = rng.standard_normal((o, i)) / i ** 0.5
        if bias:
            sd[f"{prefix}{pre}.bias"] = rng.standard_normal(o) * 0.1
    for i in range(2):
        if flags[i]:
            sd[f"{prefix}layers.{i}.weights"] = rng.standard_normal(
                (K, 2 * D, D)) / (2 * D) ** 0.5
            lin(f"env_encoders.{env}", D, K)
            env += 1
        elif bb == "sage":
            lin(f"layers.{i}.lin_l", D, D)
            lin(f"layers.{i}.lin_r", D, D, bias=False)
        elif bb == "gin":
            lin(f"layers.{i}.nn", D, D)
            sd[f"{prefix}layers.{i}.eps"] = np.array([0.25])
        elif bb == "gcn":
            lin(f"layers.{i}.lin", D, D, bias=False)
            sd[f"{prefix}layers.{i}.bias"] = rng.standard_normal(D)
        sd[f"{prefix}norms.{i}.weight"] = rng.standard_normal(D)
        sd[f"{prefix}norms.{i}.bias"] = rng.standard_normal(D)
        sd[f"{prefix}norms.{i}.running_mean"] = rng.standard_normal(D)
        sd[f"{prefix}norms.{i}.running_var"] = rng.uniform(0.5, 1.5, D)
        sd[f"{prefix}norms.{i}.num_batches_tracked"] = np.array(7)
    return {k: np.asarray(v, np.int64 if "tracked" in k else np.float32)
            for k, v in sd.items()}


def _same_trees(got, want):
    lg, lw = _leaves(got), _leaves(want)
    assert set(lg) == set(lw), set(lg) ^ set(lw)
    for k, v in lw.items():
        np.testing.assert_array_equal(lg[k].reshape(v.shape), v, err_msg=k)


@pytest.mark.parametrize("name", ["sage", "moe_last", "moe_all", "gin",
                                  "gcn"])
def test_import_encoder_matches_jax(name, tmp_path):
    """``import_encoder`` of a random reference state_dict, as a mapping
    and as a ``.pt`` file, holds the trees JAX's ``import_encoder`` builds
    (bit for bit; gin's [1] eps as the port's 0-dim parameter), and the
    imported encoder encodes as JAX's trees do."""
    jc, pc = _enc_cfgs(name)
    sd = _ref_encoder_sd(name, np.random.default_rng(8))
    jp, js = _np(jax_import.import_encoder(sd, jc))
    path = str(tmp_path / "encoder_1.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    for src in (sd, path):
        enc = port_import.import_encoder(src, pc)
        assert not enc.training
        gp, gs = _module_trees(enc)
        _same_trees({"p": gp, "s": gs}, {"p": jp, "s": js})
    x, s, r, em, nm = _graph()
    z_j, _, _ = jenc.encoder_apply(jp, js, jc, jnp.asarray(x), jnp.asarray(s),
                                   jnp.asarray(r), edge_mask=jnp.asarray(em))
    z_p = enc(_t(x), _t(s).long(), _t(r).long(), edge_mask=_t(em))
    np.testing.assert_allclose(z_p.detach().numpy(), np.asarray(z_j), **FWD)


def test_import_refuses_gat_as_jax_does():
    jc, pc = _enc_cfgs("gat")
    sd = _ref_encoder_sd("sage", np.random.default_rng(0))
    with pytest.raises(NotImplementedError):
        jax_import.import_encoder(sd, jc)
    with pytest.raises(NotImplementedError, match="gat"):
        port_import.import_encoder(sd, pc)


@pytest.mark.parametrize("name", ["sage", "moe_last"])
def test_import_pretrain_model_matches_jax(name):
    """A whole reference PretrainModel state_dict (student, VQ with its
    projections and codebook buffers, the four heads, the sem_encoder
    teacher) through ``import_pretrain_model``, ``import_vq`` and
    ``import_task_decoder``: the trees of JAX's importer bit for bit."""
    rng = np.random.default_rng(9)
    jc, pc = _enc_cfgs(name)
    vq_j = jcfg.VQConfig(dim=D, codebook_size=8, codebook_dim=D, heads=2)
    cfg_p = pcfg.PretrainConfig(
        encoder=pc, vq=pcfg.from_dict(pcfg.VQConfig(), vars(vq_j).copy()))
    sd = {**_ref_encoder_sd(name, rng, "encoder."),
          **_ref_encoder_sd(name, rng, "sem_encoder.")}
    f32 = lambda *shape: rng.standard_normal(shape).astype(  # noqa: E731
        np.float32)
    for pre, i, o in (("vq.project_in", D, 2 * D), ("vq.project_out",
                                                    2 * D, D),
                      ("feat_recon_decoder", D, D),
                      ("topo_recon_decoder.lin", D, D),
                      ("topo_sem_recon_decoder", 2 * D, D),
                      ("sem_projector", D, D)):
        sd[pre + ".weight"], sd[pre + ".bias"] = f32(o, i), f32(o)
    sd["vq._codebook.embed"] = f32(2, 8, D)
    sd["vq._codebook.embed_avg"] = f32(2, 8, D)
    sd["vq._codebook.cluster_size"] = f32(2, 8)
    sd["vq._codebook.initted"] = np.array([True])
    jp, jt, js = _np(jax_import.import_pretrain_model(sd, jc, vq_j))
    model, teacher = port_import.import_pretrain_model(sd, cfg_p)
    assert not any(p.requires_grad for p in teacher.parameters())
    gp, gt, gs = pretrain_to_jax(model, teacher)
    _same_trees({"p": gp, "t": gt, "s": gs}, {"p": jp, "t": jt, "s": js})
    vq = port_import.import_vq({k[3:]: v for k, v in sd.items()
                                if k.startswith("vq.")}, cfg_p.vq)
    _same_trees(_module_trees(vq)[0], jp["vq"])
    dec = port_import.import_task_decoder(
        {"decoder.weight": f32(5, D), "decoder.bias": f32(5)})
    want = _np(jax_import.import_task_decoder(
        {"decoder.weight": dec.w.detach().numpy().T,
         "decoder.bias": dec.b.detach().numpy()}))
    _same_trees({"w": dec.w.detach().numpy(), "b": dec.b.detach().numpy()},
                want)


# ------------------------------------------------ --save_model / predict

def _load_jax_infer():
    spec = importlib.util.spec_from_file_location(
        "repo_infer", os.path.join(ROOT, "infer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["gcn", "gin", "gat", "moe_last"])
def test_saved_models_of_each_backbone_predict_across_packages(
        name, tmp_path, monkeypatch):
    """A ``--save_model`` file of each package (the port's from one epoch
    of ``run_finetune``, JAX's from its saver on its initial task model)
    through both packages' ``infer --mode predict``: the same
    probabilities to 1e-5 and the same argmax; the port's snapshot
    predicts what its best evaluation predicted."""
    bb, moe = BACKBONES[name]
    ds_kw = dict(name="cora_synthetic", num_nodes=200, num_classes=4,
                 feat_dim=D, avg_degree=5, num_splits=1, train_per_split=100,
                 val_per_split=50, seed=0)
    ds_j = jax_synthetic.synthetic_node_dataset(**ds_kw)
    ds_p = port_synthetic.synthetic_node_dataset(**ds_kw)
    jc, pc = _enc_cfgs(name)
    cfg = jcfg.FinetuneConfig(
        encoder=jc, vq=jcfg.VQConfig(dim=D, codebook_size=8, codebook_dim=D,
                                     heads=2, commitment_weight=0.25),
        dataset="cora_synthetic", task="node", num_classes=4, epochs=1,
        repeat=1, epoch_chunk=0, lamda_env=0.1)
    params, state = _np(jax_task.task_model_init(jax.random.PRNGKey(0),
                                                 cfg))
    state["vq"]["initted"] = np.asarray(True)
    files = {"jax": str(tmp_path / "jax.npz"),
             "port": str(tmp_path / "port.npz")}
    snap, save = jax_ft._make_model_saver(files["jax"], cfg)
    snap(params, {}, state, 50.0)
    save()
    pcf = pcfg.from_dict(pcfg.FinetuneConfig(), {
        **{k: v for k, v in vars(cfg).items() if k not in ("encoder", "vq")},
        "encoder": vars(jc).copy(), "vq": vars(cfg.vq).copy()})
    monkeypatch.setattr(port_ft, "task_model_init",
                        lambda *a, **k: task_model_from_jax(params, state,
                                                            pcf))
    res = port_ft.run_finetune(ds_p, pcf, device="cpu",
                               save_model_to=files["port"])
    from stemgnn_tpu.data import registry as jax_registry
    monkeypatch.setattr(jax_registry, "load_dataset", lambda *a, **k: ds_j)
    monkeypatch.setattr(port_infer_cli, "load_dataset", lambda *a, **k: ds_p)
    jax_cli = _load_jax_infer()
    for owner, path in files.items():
        common = ["--mode", "predict", "--finetune_dataset",
                  "cora_synthetic", "--feat_dim", str(D), "--model", path]
        out_j = str(tmp_path / f"{owner}_by_jax.npz")
        monkeypatch.setattr(sys, "argv", ["infer.py", *common, "--out",
                                          out_j])
        jax_cli.main()
        out_p = str(tmp_path / f"{owner}_by_port.npz")
        port_infer_cli.main([*common, "--out", out_p, "--device", "cpu"])
        a, b = np.load(out_j), np.load(out_p)
        assert b["probs"].shape == (ds_p.num_nodes, 4)
        np.testing.assert_allclose(b["probs"], a["probs"], rtol=1e-5,
                                   atol=1e-6)
        assert np.array_equal(a["pred"], b["pred"])
        if owner == "port":
            np.testing.assert_allclose(b["probs"],
                                       res["best_pred"][:ds_p.num_nodes],
                                       rtol=1e-5, atol=1e-6)
