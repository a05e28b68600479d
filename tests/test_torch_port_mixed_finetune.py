"""The port's mixed precision against the JAX package on the CPU, the
finetune half (split from ``test_torch_port_mixed.py``, whose docstring
states the tolerances and whose helpers this file shares): the ``--bf16``
node and link finetune steps, the graph task's ``eval_bf16`` (predictions,
the device and host AUCs), and the finetune CLI's configs and runs under
``--bf16`` and ``--eval_bf16 1``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.models import task as jax_task
from stemgnn_tpu.train import finetune_loop as jax_ft
from stemgnn_tpu.vq import codebook as jax_cb
from stemgnn_tpu.vq.quantize import vq_apply
from stemgnn_tpu_torch import finetune as port_finetune_cli
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import registry as port_registry
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.models import task as port_task
from stemgnn_tpu_torch.ops.chip_profile import V5E
from stemgnn_tpu_torch.train import finetune_loop as port_ft
from stemgnn_tpu_torch.train.graph_setup import fused_full_graph
from stemgnn_tpu_torch.utils import metrics as port_metrics
from stemgnn_tpu_torch.utils.convert import (task_model_from_jax,
                                             task_model_to_jax)
from test_torch_port_mixed import (D, ROUTE_TOL, SMALL, _grads_as_model,
                                   _jax_config, _leaves, _loss_close, _np,
                                   _same_config, _Stop)


# how far below its own best score JAX may score a VQ code the port picked
# (the top two scores of a row are this close for about 14% of the rows of
# the finetune step test, and 0.06 apart at the median)
GAP_TOL = 1.5e-2


# --------------------------------------------------- the --bf16 finetune

def _ft_task(task, seed=0):
    """A JAX FinetuneConfig under ``finetune --bf16`` (the encoder bf16,
    the VQ f32) and its task-model trees, with non-trivial BatchNorm
    statistics."""
    classes = 11 if task == "link" else 5
    cfg = jcfg.FinetuneConfig(
        encoder=jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="batch", dropout=0.0,
                                   compute_dtype="bfloat16"),
        vq=jcfg.VQConfig(dim=D, codebook_size=16, codebook_dim=D, heads=4,
                         commitment_weight=0.25),
        task=task, num_classes=classes, lr=1e-3, hub_size=64,
        sc_hub_size=64)
    params, state = (_np(t) for t in jax_task.task_model_init(
        jax.random.PRNGKey(seed), cfg))
    params = jax.tree_util.tree_map(np.array, params)
    state = jax.tree_util.tree_map(np.array, state)
    rng = np.random.default_rng(seed)
    for bn in state["encoder"]["norms"]:
        bn["mean"] = rng.normal(0, 0.1, D).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, D).astype(np.float32)
    return cfg, params, state


def _ft_dataset(pkg, task):
    if task == "link":
        return pkg.synthetic_link_dataset(num_entities=300, num_relations=11,
                                          num_edges=1500, feat_dim=D, seed=3)
    return pkg.synthetic_node_dataset(num_nodes=400, num_classes=5,
                                      feat_dim=D, avg_degree=8,
                                      pref_attach=1.1, num_splits=1, seed=3)


def _rows(ds, task, n_pad):
    n = ds.num_edges if task == "link" else ds.num_nodes
    y = np.zeros(n_pad, np.int64)
    y[:n] = ds.labels
    mask = np.zeros(n_pad, bool)
    mask[:n] = ds.splits[0]["train"]
    return y, mask


@pytest.mark.parametrize("route", ["plain", "layout"])
@pytest.mark.parametrize("task", ["node", "link"])
def test_bf16_finetune_step_matches_jax(task, route, monkeypatch):
    """One full-batch ``--bf16`` finetune step (node, and link on typed
    edges) against JAX's ``_make_node_steps`` + ``optax.adamw`` on its
    plain CPU graph, from the same weights, on the layout-free route and on
    the layout (hub blocks with bf16 partials; kernel 2's and, on typed
    edges, kernel 3's plain versions with bf16 outputs).

    The two packages' bf16 encoders differ by bf16 noise, which moves about
    1% of the frozen VQ's codes at near-ties, and a moved code changes its
    row's decoder input outright.  So the port's codes are handed to JAX's
    step (as the pretrain tests hand JAX's draws to the port), and only
    where JAX scores the port's code within ``GAP_TOL`` of its own best
    (measured at most 0.0096).  Then: the loss parts within the JAX
    package's 2% gate; the gradients AdamW was handed (the decoder, the
    rows the link task gathers, the bf16 BatchNorm, the f32 VQ's bf16
    projections) f32, within 3% of the largest of JAX's f32 gradients on
    the same codes (measured 2.4%) and within 4% of the largest of JAX's
    under ``--bf16`` (measured 3.1%: JAX's bf16 scatter-add moves its own
    gradients further from the f32 ones than the port's f32 sums do); every
    updated trainable parameter within 2.1 * lr of JAX's (AdamW's first
    step moves each by about lr * sign(grad), so this holds the step's size, not its gradient); the frozen VQ unchanged."""
    cfg, params, state = _ft_task(task)
    ds_j = _ft_dataset(jax_synthetic, task)
    graph = ds_j.to_graph()
    n_pad = (graph.num_edges_padded if task == "link"
             else graph.num_nodes_padded)
    y, mask = _rows(ds_j, task, n_pad)

    pc = pcfg.from_dict(pcfg.FinetuneConfig(), {
        "encoder": vars(cfg.encoder).copy(), "vq": vars(cfg.vq).copy(),
        **{k: getattr(cfg, k) for k in ("task", "num_classes", "lr",
                                        "hub_size", "sc_hub_size")}})
    model = task_model_from_jax(params, state, pc)
    g = fused_full_graph(_ft_dataset(port_synthetic, task), pc,
                         device="cpu", use_layout=route == "layout",
                         profile=V5E)
    assert (g.layout is not None) == (route == "layout")
    if route == "layout":
        assert g.layout.hub_r is not None
    _, step, _ = port_ft._make_node_steps(pc, task)
    opt = port_ft.make_optimizer(port_ft._split_params(model, pc)[0], pc)
    vq_before = {k: v.detach().clone() for k, v in
                 model.vq.named_parameters()}
    codes, vq_forward = [], model.vq.forward
    monkeypatch.setattr(model.vq, "forward", lambda *a, **k: (
        lambda res: codes.append(res["indices"].numpy()) or res)(
            vq_forward(*a, **k)))
    losses_p = step(model, opt, torch.from_numpy(mask), g,
                    torch.from_numpy(y))
    assert len(codes) == 1 and codes[0].shape[0] >= n_pad

    # JAX's step on the port's codes; the gap JAX scores them below its own
    forced = jnp.asarray(codes[0][:n_pad].T)                      # [H, N]
    rows = np.asarray(graph.edge_mask if task == "link" else graph.node_mask)
    cosine = jax_cb.cosine_distances

    def jax_step(c):
        gaps, grads = [], []

        def cosine_forced(xh, embed):
            d = cosine(xh, embed)
            chosen = jnp.take_along_axis(d, forced[..., None], -1)[..., 0]
            jax.debug.callback(lambda v: gaps.append(np.asarray(v)),
                               d.max(-1) - chosen)
            return d + 4.0 * jax.nn.one_hot(forced, d.shape[-1],
                                            dtype=d.dtype)
        monkeypatch.setattr(jax_cb, "cosine_distances", cosine_forced)
        tx = optax.chain(optax.GradientTransformation(   # records them
            lambda p: optax.EmptyState(),
            lambda g, s, p=None: (grads.append(g) or g, s)),
            optax.adamw(c.lr, weight_decay=0.01))
        trainable, frozen = jax_ft._split_params(params, c)
        new, _, _, losses, _ = jax_ft._make_node_steps(c, task)[0](
            trainable, frozen, tx.init(trainable), state,
            jax.random.PRNGKey(0), jnp.asarray(mask), graph,
            jnp.asarray(y.astype(np.int32)), tx)
        monkeypatch.setattr(jax_cb, "cosine_distances", cosine)
        assert len(gaps) == 1 and len(grads) == 1
        assert float(gaps[0][:, rows].max()) <= GAP_TOL
        return new, losses, _leaves(_np({k: grads[0][k] for k in (
            "encoder", "decoder")}))
    new_j, losses_j, grads_j = jax_step(cfg)
    grads_f32 = jax_step(dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, compute_dtype="float32")))[2]

    for k in ("loss", "act_loss"):
        _loss_close(float(losses_p[k]), float(losses_j[k]), k)

    def trees(m):
        return _leaves({"encoder": task_model_to_jax(m)[0]["encoder"],
                        "decoder": {"w": m.decoder.w.detach().numpy(),
                                    "b": m.decoder.b.detach().numpy()}})
    grads_p = trees(_grads_as_model(model))
    checks = [(grads_p, want, tol * max(float(np.abs(v).max())
                                        for v in want.values()))
              for want, tol in ((grads_f32, 3e-2), (grads_j, 4e-2))]
    checks.append((trees(model), _leaves({"encoder": _np(new_j["encoder"]),
                                          "decoder": _np(new_j["decoder"])}),
                   2.1 * cfg.lr))
    for got, want, tol in checks:
        assert set(got) == set(want)
        for path, leaf in want.items():
            assert got[path].dtype == np.float32
            np.testing.assert_allclose(got[path], leaf, rtol=0, atol=tol,
                                       err_msg=path)
    for k, v in model.vq.named_parameters():
        assert torch.equal(v, vq_before[k]), k


# ------------------------------------------------------------ eval_bf16

def _mol_cfg(**kw):
    base = dict(
        encoder=jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="batch", dropout=0.0),
        vq=jcfg.VQConfig(dim=D, codebook_size=8, codebook_dim=D, heads=2,
                         commitment_weight=0.25, kmeans_init=True),
        task="graph", num_classes=4, epochs=2, early_stop=100, lr=1e-3,
        repeat=1, batch_size=16, dataset="mol_synthetic")
    base.update(kw)
    return jcfg.FinetuneConfig(**base)


@pytest.mark.parametrize("bf16", ["eval_bf16", "bf16_eval_bf16"])
def test_graph_task_eval_bf16_matches_jax(bf16, monkeypatch):
    """``run_finetune(task="graph")`` with ``eval_bf16`` (training f32,
    the evaluation's encoder bf16), and with ``--bf16`` as well, against
    JAX's from JAX's initial task model and k-means means on 64
    ``mol_synthetic`` molecules (an 8-code codebook, as the graph tests
    use): the same epochs logged, each epoch's loss within the 2% gate;
    the evaluation's encoder ran in bf16 (its ``z`` is bf16) while
    training's did not under ``eval_bf16`` alone.  The AUCs are not
    compared here: the two packages' bf16 pooled embeddings differ by bf16
    noise (JAX adds a molecule's node rows one at a time in bf16), which
    flips a molecule's VQ code at a near-tie and moves a small split's AUC
    by points; ``test_eval_bf16_predictions_match_jax`` holds the
    predictions themselves."""
    cfg = _mol_cfg(eval_bf16=True)
    if bf16 == "bf16_eval_bf16":
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, compute_dtype="bfloat16"))
    kw = dict(num_graphs=64, num_tasks=4, feat_dim=D, seed=1)
    rows = {"jax": [], "port": []}
    for who, mod in (("jax", jax_ft), ("port", port_ft)):
        class Recorder(mod.Logger):
            def log(self, run, epoch, loss, result, _who=who):
                rows[_who].append((epoch, dict(loss), dict(result)))
                return super().log(run, epoch, loss, result)
        monkeypatch.setattr(mod, "Logger", Recorder)
    inits, means = [], []
    real_init, real_sample = (jax_task.task_model_init,
                              jax_cb.batched_sample_vectors)
    monkeypatch.setattr(jax_task, "task_model_init", lambda *a, **k: (
        inits.append(_np(real_init(*a, **k))) or real_init(*a, **k)))
    monkeypatch.setattr(jax_cb, "batched_sample_vectors", lambda *a, **k: (
        means.append(np.asarray(real_sample(*a, **k))) or means[-1]))
    jax_ft.run_finetune(jax_synthetic.synthetic_graph_dataset(**kw), cfg)
    fields = {f.name for f in dataclasses.fields(pcfg.FinetuneConfig)}
    pc = pcfg.from_dict(pcfg.FinetuneConfig(), {
        "encoder": vars(cfg.encoder).copy(), "vq": vars(cfg.vq).copy(),
        **{k: v for k, v in vars(cfg).items()
           if k in fields and k not in ("encoder", "vq")}})
    monkeypatch.setattr(port_ft, "task_model_init",
                        lambda *a, **k: task_model_from_jax(*inits[0], pc))
    real_km = port_ft.maybe_kmeans_init_vq
    monkeypatch.setattr(port_ft, "maybe_kmeans_init_vq",
                        lambda model, cfg_, g, **k: real_km(
                            model, cfg_, g,
                            means=torch.from_numpy(means[0].copy())))
    dtypes = []
    real_encode = port_ft.encode

    def encode_rec(model, g, **k):
        out = real_encode(model, g, **k)
        z = out[0] if k.get("return_aux") else out
        dtypes.append((model.training, z.dtype))
        return out
    monkeypatch.setattr(port_ft, "encode", encode_rec)
    port_ft.run_finetune(port_synthetic.synthetic_graph_dataset(**kw), pc,
                         device="cpu")
    train_dt = (torch.bfloat16 if bf16 == "bf16_eval_bf16"
                else torch.float32)
    assert {dt for tr, dt in dtypes if tr} == {train_dt}
    assert {dt for tr, dt in dtypes if not tr} == {torch.bfloat16}
    assert [r[0] for r in rows["port"]] == [r[0] for r in rows["jax"]]
    for (e, lw, _), (_, lg, rg) in zip(rows["jax"], rows["port"]):
        _loss_close(lg["loss"], lw["loss"], f"epoch {e}")
        assert all(0 <= rg[k] <= 100 for k in ("train", "val", "test"))


def test_eval_bf16_predictions_match_jax():
    """The graph task's evaluation forward under ``eval_bf16`` on the same
    weights (an f32-trained task model, a random 8-code codebook) against
    JAX's (``encode`` with its ``eval_cfg``, the mean pool, ``task_logits``,
    the head mean), batch by batch over 64 ``mol_synthetic`` molecules:
    the molecules whose codes agree (at least 90%; a code differs only at
    a near-tie, whose score gap is printed) hold their head-mean logits
    within the bf16 route tolerance; the port's predictions with and
    without ``eval_bf16`` differ (the bf16 forward really ran)."""
    cfg = _mol_cfg(eval_bf16=True,
                   vq=jcfg.VQConfig(dim=D, codebook_size=8, codebook_dim=D,
                                    heads=2, commitment_weight=0.25))
    eval_cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, compute_dtype="bfloat16"))
    params, state = (_np(t) for t in jax_task.task_model_init(
        jax.random.PRNGKey(0), cfg))
    kw = dict(num_graphs=64, num_tasks=4, feat_dim=D, seed=1)
    graphs_j = jax_synthetic.synthetic_graph_dataset(**kw)[0]
    graphs_p = port_synthetic.synthetic_graph_dataset(**kw)[0]
    fields = {f.name for f in dataclasses.fields(pcfg.FinetuneConfig)}
    pc = pcfg.from_dict(pcfg.FinetuneConfig(), {
        "encoder": vars(cfg.encoder).copy(), "vq": vars(cfg.vq).copy(),
        **{k: v for k, v in vars(cfg).items()
           if k in fields and k not in ("encoder", "vq")}})
    model = task_model_from_jax(params, state, pc)
    bs = 16
    predict_bf16 = port_ft._make_graph_steps(pc, bs, bs, True)[2]
    predict_f32 = port_ft._make_graph_steps(pc, bs, bs, False)[2]
    dummy = np.zeros((64, 4))
    got, got32, want, codes = [], [], [], []
    batches_j = jax_ft._batch_graph_list(graphs_j, dummy, np.arange(64), bs)
    batches_p = port_ft._batch_graph_list(graphs_p, dummy, np.arange(64), bs)
    for (gj, _, n), (gp, _, _) in zip(batches_j, batches_p):
        z, st2, _ = jax_task.encode(params, state, eval_cfg, gj,
                                    training=False)
        pooled = jax_task.pool_graph(z, gj, "mean", num_segments=bs)
        logits, _, _ = jax_task.task_logits(params, st2, eval_cfg, pooled,
                                            training=False)
        want.append(np.asarray(jnp.mean(logits, axis=1))[:n])
        gpt = port_ft.graph_to_device(gp, "cpu")
        got.append(predict_bf16(model, gpt)[:n].numpy())
        got32.append(predict_f32(model, gpt)[:n].numpy())
        zp = port_task.encode(model, gpt, compute_dtype="bfloat16")
        pooled_p = port_task.pool_graph(zp, gpt, "mean", num_segments=bs)
        ind_j = np.asarray(vq_apply(params["vq"], st2["vq"], eval_cfg.vq,
                                    pooled, training=False)["indices"])[:n]
        with torch.no_grad():
            ind_p = model.vq(pooled_p)["indices"][:n].numpy()
        codes.append((ind_j == ind_p).all(1))
    got, got32, want = (np.concatenate(a) for a in (got, got32, want))
    same = np.concatenate(codes)
    print(f"codes equal on {same.mean():.4f} of the molecules")
    assert same.mean() >= 0.9
    np.testing.assert_allclose(got[same], want[same], **ROUTE_TOL)
    assert not np.array_equal(got, got32)


def test_graph_task_device_and_host_auc_take_eval_bf16(monkeypatch,
                                                      tmp_path):
    """Both evaluation routes of the graph task run the bf16 evaluation
    forward: the indexed bundle's device AUC and the materialized
    bundle's host AUC (the device AUC within 1e-6 of the host AUC of the
    same bf16 predictions)."""
    seen = []
    real_encode = port_ft.encode

    def encode_rec(model, g, **k):
        z = real_encode(model, g, **k)
        if not model.training:
            seen.append(z.dtype)
        return z
    monkeypatch.setattr(port_ft, "encode", encode_rec)
    aucs = []
    real_dev = port_ft.device_multitask_auc

    def dev_rec(preds, y, valid):
        out = real_dev(preds, y, valid)
        host = port_metrics.evaluate(preds.numpy(), torch.where(
            valid, y, torch.full_like(y, float("nan"))).numpy(), None,
            "graph")
        aucs.append((float(out) * 100, host))
        return out
    monkeypatch.setattr(port_ft, "device_multitask_auc", dev_rec)
    pc = pcfg.FinetuneConfig(
        encoder=pcfg.EncoderConfig(input_dim=D, hidden_dim=D),
        vq=pcfg.VQConfig(dim=D, codebook_size=8, codebook_dim=D, heads=2,
                         kmeans_init=True),
        task="graph", num_classes=4, epochs=1, repeat=1, batch_size=16,
        eval_bf16=True)
    graphs = port_synthetic.synthetic_graph_dataset(num_graphs=48,
                                                    num_tasks=4, feat_dim=D)
    res = port_ft.run_finetune(graphs, pc, device="cpu")
    assert res["eval_route"].startswith("host AUC")
    assert seen and set(seen) == {torch.bfloat16}
    seen.clear()
    csv = str(tmp_path / "mols.csv")
    port_synthetic.write_smiles_csv(csv, 48, num_tasks=4, nan_frac=0.2)
    res = port_ft.run_finetune(port_registry.load_dataset(
        f"smiles:{csv}", feat_dim=D), pc, device="cpu")
    assert res["eval_route"].startswith("device AUC")
    assert seen and set(seen) == {torch.bfloat16}
    assert aucs
    for dev_auc, host_auc in aucs:
        assert abs(dev_auc - host_auc) <= 1e-6 * 100, (dev_auc, host_auc)


@pytest.mark.parametrize("flags", [
    ["--bf16"], ["--bf16", "--finetune_dataset", "kg_synthetic"],
    ["--eval_bf16", "1", "--finetune_dataset", "mol_synthetic"],
    ["--bf16", "--eval_bf16", "1", "--finetune_dataset", "mol_synthetic"]],
    ids=["bf16_node", "bf16_link", "eval_bf16_graph", "bf16_eval_bf16"])
def test_finetune_cli_bf16_config_equals_jax(flags, monkeypatch):
    """``finetune.py --bf16`` (the encoder's compute dtype, JAX
    finetune.py:231) and ``--eval_bf16 1`` (passed through, :249): the
    port's config equals the one JAX's CLI hands its ``run_finetune``."""
    argv = ["--finetune_dataset", "cora_synthetic", "--pretrain_dataset",
            "na", *SMALL, "--debug", *flags]
    want = _jax_config(monkeypatch, "finetune", argv, "run_finetune")
    seen = {}

    def stop(ds, cfg, *a, **k):
        seen["cfg"] = cfg
        raise _Stop
    monkeypatch.setattr(port_finetune_cli, "run_finetune", stop)
    with pytest.raises(_Stop):
        port_finetune_cli.main([*argv, "--device", "cpu"])
    got = dataclasses.asdict(seen["cfg"])
    _same_config(got, want)
    assert got["encoder"]["compute_dtype"] == (
        "bfloat16" if "--bf16" in flags else "float32")
    assert got["vq"]["compute_dtype"] == "float32"
    assert got["eval_bf16"] == ("--eval_bf16" in flags)


@pytest.mark.parametrize("flags", [
    ["--bf16"], ["--bf16", "--finetune_dataset", "kg_synthetic"],
    ["--bf16", "--finetune_dataset", "mol_synthetic"],
    ["--eval_bf16", "1", "--finetune_dataset", "mol_synthetic"],
    ["--bf16", "--batch_size", "64"],
    ["--bf16", "--finetune_dataset", "kg_synthetic", "--batch_size", "512",
     "--eval_chunked", "1"]],
    ids=["node", "link", "graph", "graph_eval_bf16", "node_minibatch",
         "link_minibatch_chunked_eval"])
def test_finetune_cli_bf16_runs_on_the_cpu(flags):
    """``finetune --bf16`` on the node, link and graph tasks, full batch
    and on minibatches (the link case with the layer-wise chunked
    evaluation), and
    ``--eval_bf16 1`` on the graph task, one epoch on the CPU from a
    k-means-initialized codebook: finite losses and metrics in [0, 100]."""
    res = port_finetune_cli.main(
        ["--finetune_dataset", "cora_synthetic", "--pretrain_dataset", "na",
         *SMALL, "--epochs", "1", "--repeat", "1", "--device", "cpu",
         "--debug", *flags])
    loss = res["epoch_losses"][0]["loss"]
    assert np.isfinite(loss)
    best = res["logger"].get_best()
    for k in ("train", "val", "test"):
        assert 0 <= best[k]["mean"] <= 100
    enc = res["model"].encoder
    assert enc.cfg.compute_dtype == ("bfloat16" if "--bf16" in flags
                                     else "float32")
    assert all(p.dtype == torch.float32 for p in res["model"].parameters())
