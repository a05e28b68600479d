"""The port's minibatch finetune, layer-wise evaluation, task-model export
and VQ options against the JAX package on the CPU: the sampler's
``shuffle=False`` / ``probe_chunks`` / ``make_batch`` batches, the minibatch
node and link finetunes (with the full and the layer-wise chunked
evaluation), ``layerwise_encode`` / ``layerwise_eval_predict`` over several
edge blocks, a ``--save_model`` file of each package predicted by the
other's ``infer --mode predict``, and ``--use_vq 0`` / ``--freeze_vq 0``.

Both packages train from the same initial task model (JAX's
``task_model_init`` trees handed to the port), with dropout 0 and JAX's
per-epoch loop (``epoch_chunk=0``).  The sampler's draws come from numpy
generators on both sides and are equal bit for bit, so every batch is the
same.  Tolerances: the per-epoch mean losses to 1e-5 (f32 on both sides,
sums in another order); each epoch's accuracies within one item of their
mask (a prediction whose top two classes nearly tie may flip).
"""

import dataclasses
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.data import native_sampler as jax_native
from stemgnn_tpu.data import sampler as jax_sampler
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.models import task as jax_task
from stemgnn_tpu.nn.encoder import encoder_init
from stemgnn_tpu.train import finetune_loop as jax_ft
from stemgnn_tpu.train import infer as jax_infer
from stemgnn_tpu.utils import checkpoint as jax_ckpt
from stemgnn_tpu.vq import vq_init
from stemgnn_tpu_torch import infer as port_infer_cli
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import sampler as port_sampler
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.train import finetune_loop as port_ft
from stemgnn_tpu_torch.train import infer as port_infer
from stemgnn_tpu_torch.utils import checkpoint as port_ckpt
from stemgnn_tpu_torch.utils.convert import task_model_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, SEED = 16, 0
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _datasets(task):
    """cora_synthetic (7 classes) or kg_synthetic (11 relations) at width
    D, from each package's generator (equal arrays)."""
    if task == "node":
        kw = dict(num_nodes=400, num_classes=5, feat_dim=D, avg_degree=6,
                  num_splits=1, train_per_split=200, val_per_split=100,
                  seed=3)
        return (jax_synthetic.synthetic_node_dataset(**kw),
                port_synthetic.synthetic_node_dataset(**kw))
    kw = dict(num_entities=300, num_edges=1500, feat_dim=D, seed=3)
    return (jax_synthetic.synthetic_link_dataset(**kw),
            port_synthetic.synthetic_link_dataset(**kw))


def _jax_cfg(task, num_classes, **kw):
    base = dict(
        encoder=jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="batch", dropout=0.0),
        vq=jcfg.VQConfig(dim=D, codebook_size=16, codebook_dim=D, heads=2,
                         commitment_weight=0.25),
        task=task, num_classes=num_classes, epochs=3, early_stop=100,
        lr=1e-3, repeat=1, epoch_chunk=0, fanout=4, link_fanout=5)
    base.update(kw)
    return jcfg.FinetuneConfig(**base)


def _port_cfg(cfg):
    fields = {f.name for f in dataclasses.fields(pcfg.FinetuneConfig)}
    return pcfg.from_dict(pcfg.FinetuneConfig(), {
        "encoder": vars(cfg.encoder).copy(), "vq": vars(cfg.vq).copy(),
        **{k: v for k, v in vars(cfg).items()
           if k in fields and k not in ("encoder", "vq")}})


def _bundle(cfg):
    """A pretrained encoder and an initted VQ (no k-means init on either
    side), as numpy trees."""
    ke, kv = jax.random.split(jax.random.PRNGKey(5))
    ep, es = encoder_init(ke, cfg.encoder)
    vp, vs = vq_init(kv, cfg.vq)
    vs = dict(vs, initted=np.asarray(True))
    return _np({"encoder_params": ep, "encoder_state": es, "vq_params": vp,
                "vq_state": vs})


def _jax_initial(cfg, bundle):
    """The task model JAX's loop builds for split 0 from ``bundle``."""
    _, k_init = jax.random.split(jax.random.PRNGKey(0))
    params, state = jax_task.task_model_init(
        k_init, cfg, encoder_params=bundle["encoder_params"],
        vq_params=bundle["vq_params"], encoder_state=bundle["encoder_state"],
        vq_state=bundle["vq_state"])
    return _np(params), _np(state)


def _run_both(cfg, ds_j, ds_p, monkeypatch, save_dir=None):
    """JAX's ``run_finetune`` and the port's from the same initial model;
    returns (JAX's per-epoch losses and accuracies, the port's result)."""
    logged = []

    class Recorder(jax_ft.Logger):
        def log(self, run, epoch, loss, result):
            logged.append((dict(loss), dict(result)))
            return super().log(run, epoch, loss, result)
    monkeypatch.setattr(jax_ft, "Logger", Recorder)
    bundle = _bundle(cfg)
    jax_ft.run_finetune(ds_j, cfg, pretrained=bundle, save_model_to=(
        "" if save_dir is None else str(save_dir / "jax.npz")))
    pc = _port_cfg(cfg)
    init = _jax_initial(cfg, bundle)
    monkeypatch.setattr(port_ft, "task_model_init",
                        lambda *a, **k: task_model_from_jax(*init, pc))
    res = port_ft.run_finetune(ds_p, pc, device="cpu", save_model_to=(
        "" if save_dir is None else str(save_dir / "port.npz")))
    return logged, res


def _check_epochs(logged, res, masks, tag):
    """Per-epoch losses to 1e-5 and accuracies within one item."""
    got = res["logger"].data[0]
    assert len(logged) == len(res["epoch_losses"]) == len(got["val"])
    sizes = {k: int(np.asarray(masks[s]).sum())
             for k, s in (("train", "train"), ("val", "valid"),
                          ("test", "test"))}
    for e, (want_loss, want_acc) in enumerate(logged):
        for k in ("loss", "act_loss", "jac_loss", "env_loss"):
            np.testing.assert_allclose(res["epoch_losses"][e][k],
                                       want_loss[k], **LOSS_TOL,
                                       err_msg=f"{tag} epoch {e} {k}")
        for k, n in sizes.items():
            assert abs(got[k][e] - want_acc[k]) <= 100.0 / n + 1e-9, (
                tag, e, k, got[k][e], want_acc[k])
    print(f"{tag}: losses {[round(x['loss'], 6) for x, _ in logged]}")


# ---------------------------------------------------------------- sampler

@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_link_sampler_batches_equal_jax(native):
    """The link loop's sampler: one iterator of ``2 * bs`` seeds over every
    node with ``shuffle=False`` and the endpoint sets as ``probe_chunks``;
    batches by ``make_batch`` of each edge chunk's endpoints, then a pass
    of ``__iter__`` in seed order.  Node ids, local edges, edge types,
    masks, the buckets (keyed by the probes) and the escalations equal
    JAX's bit for bit."""
    if native:
        assert jax_native.native_available()
    ds_j, ds_p = _datasets("link")
    ei, n = ds_p.edge_index, ds_p.num_nodes
    rng_ids = np.random.default_rng(4)
    edge_ids = rng_ids.permutation(ds_p.num_edges)[:600]
    bs = 64
    probe = [np.unique(np.concatenate([ei[0][edge_ids[i * bs:(i + 1) * bs]],
                                       ei[1][edge_ids[i * bs:(i + 1) * bs]]]))
             for i in range(min(12, len(edge_ids) // bs))]
    its = [jax_sampler.NeighborBatchIterator(
        jax_sampler.CSCGraph.from_edge_index(ei, n), None, None, ds_j.x,
        ds_j.xe, np.arange(n), 2 * bs, [5, 5], np.random.default_rng(9),
        shuffle=False, indexed=True, probe_chunks=probe, use_native=native),
        port_sampler.NeighborBatchIterator(
        port_sampler.CSCGraph.from_edge_index(ei, n), ds_p.x, ds_p.xe,
        np.arange(n), 2 * bs, [5, 5], np.random.default_rng(9),
        shuffle=False, probe_chunks=probe, use_native=native)]
    assert its[1]._native == native
    assert (its[0].node_pad, its[0].edge_pad) == (its[1].node_pad,
                                                  its[1].edge_pad)

    def same(bj, bp):
        (gj, sj, nj), (gp, sp, np_) = bj, bp
        for f in ("node_ids", "senders", "receivers", "node_mask",
                  "edge_mask", "xe_ids"):
            assert np.array_equal(np.asarray(getattr(gj, f)),
                                  getattr(gp, f)), f
        assert sj == sp and np.array_equal(nj, np_)
    for i in range(0, len(edge_ids), bs):
        chunk = edge_ids[i:i + bs]
        uniq = np.unique(np.concatenate([ei[0][chunk], ei[1][chunk]]))
        same(its[0].make_batch(uniq), its[1].make_batch(uniq))
    count = 0
    for bj, bp in zip(*its):
        same(bj, bp)
        count += 1
    assert count == len(its[1]) == -(-n // (2 * bs))
    # seed order: the first batch holds the first 2 * bs node ids
    assert np.array_equal(next(iter(its[1]))[2][:2 * bs], np.arange(2 * bs))
    for attr in ("node_pad", "edge_pad", "escalations", "truncations"):
        assert getattr(its[0], attr) == getattr(its[1], attr), attr
    # the probes key the bucket cache: other probes, another entry
    csc = port_sampler.CSCGraph.from_edge_index(ei, n)
    for chunks in (probe, probe[::-1]):
        port_sampler.NeighborBatchIterator(
            csc, ds_p.x, ds_p.xe, np.arange(n), 2 * bs, [5, 5],
            np.random.default_rng(9), shuffle=False, probe_chunks=chunks,
            use_native=native)
    assert len(csc._pad_cache) == 2


# ------------------------------------------------------- minibatch loops

@pytest.mark.parametrize("task,bs", [("node", 64), ("link", 256)])
def test_minibatch_finetune_matches_jax(task, bs, monkeypatch):
    """``run_finetune`` with ``batch_size > 0`` against JAX's (3 epochs,
    full-batch evaluation each epoch): node batches of ``bs`` train seeds,
    link batches of ``bs`` train edges sampled from one ``2 * bs``
    iterator; the history's batch count and host times."""
    ds_j, ds_p = _datasets(task)
    cfg = _jax_cfg(task, ds_p.num_classes, batch_size=bs)
    logged, res = _run_both(cfg, ds_j, ds_p, monkeypatch)
    _check_epochs(logged, res, ds_p.splits[0], f"minibatch {task}")
    n_train = int(np.asarray(ds_p.splits[0]["train"]).sum())
    for h in res["history"]:
        assert h["batches"] == -(-n_train // bs)
        assert h["host/sample_ms"] > 0 and h["host/transfer_ms"] > 0
        assert "device_ms" not in h           # CUDA events only on CUDA


def test_minibatch_link_with_chunked_eval_matches_jax(monkeypatch):
    """``eval_chunked`` with minibatches: no full graph is built, and each
    epoch's evaluation streams the layers over edge blocks (three blocks
    of the 1,500 edges) on both sides."""
    ds_j, ds_p = _datasets("link")
    cfg = _jax_cfg("link", ds_p.num_classes, batch_size=256,
                   eval_chunked=True, eval_edge_block=512)
    logged, res = _run_both(cfg, ds_j, ds_p, monkeypatch)
    assert res["graph"] is None
    _check_epochs(logged, res, ds_p.splits[0], "chunked link")


def test_graph_free_kmeans_init_covers_every_node():
    """Without a full graph (chunked evaluation + minibatches) a codebook
    that is not initted is k-means-initialized over the layer-wise
    encoding: every node lands in a bin of every head."""
    _, ds_p = _datasets("node")
    cfg = _port_cfg(_jax_cfg("node", ds_p.num_classes, batch_size=64,
                             eval_chunked=True, eval_edge_block=256,
                             epochs=1))
    cfg = dataclasses.replace(cfg, vq=dataclasses.replace(cfg.vq,
                                                          kmeans_init=True))
    res = port_ft.run_finetune(ds_p, cfg, device="cpu")
    vq = res["model"].vq
    assert res["graph"] is None and bool(vq.initted)
    sizes = vq.cluster_size.sum(1).tolist()
    assert sizes == [float(ds_p.num_nodes)] * cfg.vq.heads


# -------------------------------------------------- layer-wise inference

@pytest.mark.parametrize("task", ["node", "link"])
def test_layerwise_inference_matches_jax(task):
    """``layerwise_encode`` (4 blocks of edges) against JAX's, and
    ``layerwise_eval_predict`` against JAX's: z and the probabilities to
    1e-5 (f32 sums in another order); the link rows are edge midpoints
    over the edge-type table."""
    ds_j, ds_p = _datasets(task)
    cfg = _jax_cfg(task, ds_p.num_classes)
    params, state = _jax_initial(cfg, _bundle(cfg))
    rng = np.random.default_rng(1)
    for bn in state["encoder"]["norms"]:
        bn["mean"] = rng.normal(0, 0.1, D).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, D).astype(np.float32)
    model = task_model_from_jax(params, state, _port_cfg(cfg))
    block = -(-ds_p.num_edges // 4)
    args = (ds_p.node_features(), ds_p.edge_index[0], ds_p.edge_index[1])
    kw = dict(xe=ds_p.xe, edge_table=ds_p.edge_text_feat,
              num_nodes=ds_p.num_nodes, edge_block=block)
    z_j, m_j = jax_infer.layerwise_encode(
        params["encoder"], state["encoder"], cfg.encoder, *args, **kw)
    z_p, m_p = port_infer.layerwise_encode(model.encoder, *args, **kw)
    assert np.array_equal(np.asarray(m_j), m_p.numpy())
    np.testing.assert_allclose(z_p.numpy(), np.asarray(z_j), rtol=1e-5,
                               atol=1e-5)
    pad = ds_p.num_edges + 7 if task == "link" else ds_p.num_nodes + 3
    want = jax_infer.layerwise_eval_predict(params, state, cfg, ds_j, task,
                                            pad, edge_block=block,
                                            node_chunk=100)
    got = port_infer.layerwise_eval_predict(model, _port_cfg(cfg), ds_p,
                                            task, pad, edge_block=block,
                                            node_chunk=100)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_layerwise_refuses_other_backbones():
    """Once the refusal of every backbone but sage (ROADMAP Queue 1 item
    5); the gat backbone streams now: ``layerwise_encode`` over 4 blocks
    of edges (the two-pass online softmax) and ``layerwise_eval_predict``
    against JAX's, z and the probabilities to 1e-5."""
    ds_j, ds_p = _datasets("node")
    cfg = _jax_cfg("node", ds_p.num_classes)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, backbone="gat"))
    params, state = _jax_initial(cfg, _bundle(cfg))
    assert "att_src" in params["encoder"]["layers"][0]
    model = task_model_from_jax(params, state, _port_cfg(cfg))
    block = -(-ds_p.num_edges // 4)
    args = (ds_p.node_features(), ds_p.edge_index[0], ds_p.edge_index[1])
    kw = dict(num_nodes=ds_p.num_nodes, edge_block=block)
    z_j, _ = jax_infer.layerwise_encode(params["encoder"], state["encoder"],
                                        cfg.encoder, *args, **kw)
    z_p, _ = port_infer.layerwise_encode(model.encoder, *args, **kw)
    np.testing.assert_allclose(z_p.numpy(), np.asarray(z_j), rtol=1e-5,
                               atol=1e-5)
    pad = ds_p.num_nodes + 3
    want = jax_infer.layerwise_eval_predict(params, state, cfg, ds_j, "node",
                                            pad, edge_block=block)
    got = port_infer.layerwise_eval_predict(model, _port_cfg(cfg), ds_p,
                                            "node", pad, edge_block=block)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------ export and --mode predict

def _load_jax_infer():
    spec = importlib.util.spec_from_file_location(
        "repo_infer", os.path.join(ROOT, "infer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("task", ["node", "link"])
def test_saved_models_predict_across_packages(task, tmp_path, monkeypatch):
    """Each package's ``--save_model`` file through the other's ``infer
    --mode predict`` (and its own): the same probabilities to 1e-5 and the
    same argmax; the meta's keys agree and the saved trees of both runs
    agree to 1e-5 when both kept the same best epoch (BatchNorm-fed biases
    and the running means they shift to 2.1 * lr a step, as in
    ``tests/test_torch_port_train.py``)."""
    name = "cora_synthetic" if task == "node" else "kg_synthetic"
    size = (dict(num_nodes=400, num_classes=5, avg_degree=6, num_splits=1,
                 train_per_split=200, val_per_split=100) if task == "node"
            else dict(num_entities=300, num_edges=1500))
    gen = {"node": "synthetic_node_dataset",
           "link": "synthetic_link_dataset"}[task]
    ds_j = getattr(jax_synthetic, gen)(name=name, feat_dim=D, seed=SEED,
                                       **size)
    ds_p = getattr(port_synthetic, gen)(name=name, feat_dim=D, seed=SEED,
                                        **size)
    cfg = _jax_cfg(task, ds_p.num_classes, dataset=name)
    logged, res = _run_both(cfg, ds_j, ds_p, monkeypatch, save_dir=tmp_path)
    files = {"jax": str(tmp_path / "jax.npz"),
             "port": str(tmp_path / "port.npz")}
    metas = {k: port_ckpt.load_meta(v) for k, v in files.items()}
    assert set(metas["jax"]) == set(metas["port"]) == {
        "config", "best_val", "task", "dataset"}
    assert metas["port"]["task"] == task and metas["port"]["dataset"] == name
    # both registries generate the dataset from the seed and --feat_dim
    from stemgnn_tpu.data import registry as jax_registry
    from stemgnn_tpu_torch.data import registry as port_registry
    for reg, ds in ((jax_registry, ds_j), (port_registry, ds_p)):
        monkeypatch.setattr(reg, "load_dataset",
                            lambda *a, _ds=ds, **k: _ds)
    jax_cli = _load_jax_infer()
    monkeypatch.setattr(port_infer_cli, "load_dataset", lambda *a, **k: ds_p)
    probs = {}
    for owner, path in files.items():
        common = ["--mode", "predict", "--finetune_dataset", name,
                  "--feat_dim", str(D), "--model", path]
        out_j = str(tmp_path / f"{owner}_by_jax.npz")
        monkeypatch.setattr(sys, "argv", ["infer.py", *common, "--out",
                                          out_j])
        jax_cli.main()
        out_p = str(tmp_path / f"{owner}_by_port.npz")
        port_infer_cli.main([*common, "--out", out_p, "--device", "cpu"])
        a, b = np.load(out_j), np.load(out_p)
        assert set(a.files) == set(b.files) == {"probs", "pred"}
        n = ds_p.num_nodes if task == "node" else ds_p.num_edges
        assert b["probs"].shape == (n, ds_p.num_classes)
        np.testing.assert_allclose(b["probs"], a["probs"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(b["probs"].sum(1), 1.0, rtol=1e-5)
        assert np.array_equal(a["pred"], b["pred"])
        probs[owner] = b["probs"]
    # the port's saved snapshot predicts what its best epoch's evaluation
    # predicted
    n = probs["port"].shape[0]
    np.testing.assert_allclose(probs["port"], res["best_pred"][:n],
                               rtol=1e-5, atol=1e-6)
    if metas["jax"]["best_val"] == metas["port"]["best_val"]:
        tj = port_ckpt.load_pytree(files["jax"])
        tp = port_ckpt.load_pytree(files["port"])
        lj, lp = _leaves(tj), _leaves(tp)
        assert set(lj) == set(lp)
        for path, leaf in lj.items():
            # lin_l's bias feeds a BatchNorm, so its true gradient is 0 and
            # AdamW turns the float noise into steps of up to lr either
            # way; the BatchNorm's running mean carries that bias
            noise = ("lin_l" in path and "'b'" in path) or (
                "norms" in path and "'mean'" in path)
            np.testing.assert_allclose(
                lp[path], leaf, rtol=1e-5,
                atol=2.1 * cfg.lr * cfg.epochs if noise else 1e-5,
                err_msg=path)


# ------------------------------------------------------ VQ options

@pytest.mark.parametrize("use_vq,freeze_vq", [(0, 1), (1, 0)])
def test_vq_options_match_jax(use_vq, freeze_vq, monkeypatch, tmp_path):
    """``--use_vq 0`` (the decoder reads ``project_in(z)``) and
    ``--freeze_vq 0`` (the VQ's parameters in the optimizer) over 3
    full-batch node epochs against JAX's: losses to 1e-5, accuracies
    within one item; under ``freeze_vq 0`` the saved codebook moved (its
    weight decay) as JAX's did, to 1e-5."""
    ds_j, ds_p = _datasets("node")
    cfg = _jax_cfg("node", ds_p.num_classes, use_vq=bool(use_vq),
                   freeze_vq=bool(freeze_vq))
    logged, res = _run_both(cfg, ds_j, ds_p, monkeypatch, save_dir=tmp_path)
    _check_epochs(logged, res, ds_p.splits[0],
                  f"use_vq {use_vq} freeze_vq {freeze_vq}")
    tj = port_ckpt.load_pytree(str(tmp_path / "jax.npz"))
    tp = port_ckpt.load_pytree(str(tmp_path / "port.npz"))
    init = res["init_params"]["vq.embed"].numpy()
    moved = not np.array_equal(tp["params"]["vq"]["embed"], init)
    assert moved == (not freeze_vq)
    assert np.array_equal(tj["params"]["vq"]["embed"], init) == bool(
        freeze_vq)
    if port_ckpt.load_meta(str(tmp_path / "jax.npz"))["best_val"] == \
            port_ckpt.load_meta(str(tmp_path / "port.npz"))["best_val"]:
        np.testing.assert_allclose(tp["params"]["vq"]["embed"],
                                   tj["params"]["vq"]["embed"], rtol=1e-5,
                                   atol=1e-5)


def test_jax_reads_the_port_checkpoint_format(tmp_path):
    """A port ``--save_model`` tree loads in JAX's checkpoint reader with the
    meta JAX's ``infer`` reads (``from_dict`` of its ``config``)."""
    _, ds_p = _datasets("node")
    pc = _port_cfg(_jax_cfg("node", ds_p.num_classes, epochs=1))
    path = str(tmp_path / "m.npz")
    port_ft.run_finetune(ds_p, pc, device="cpu", save_model_to=path)
    tree = jax_ckpt.load_pytree(path)
    meta = jax_ckpt.load_meta(path)
    cfg = jcfg.from_dict(jcfg.FinetuneConfig(), meta["config"])
    assert cfg.num_classes == ds_p.num_classes and cfg.vq.heads == 2
    assert set(tree) == {"params", "state"}
    assert set(tree["params"]) == {"encoder", "vq", "decoder"}
    assert set(tree["state"]) == {"encoder", "vq"}
