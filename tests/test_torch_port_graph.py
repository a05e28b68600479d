"""The port's graph task against the JAX package on the CPU: disjoint
batches (``batch_graphs``, ``batch_indexed_graphs``, ``_batch_graph_list``
with its shuffle), ``pool_graph`` (mean, sum, max), the multitask BCE, the
host and device AUCs, one training step, whole ``run_finetune`` runs on a
materialized bundle (``mol_synthetic``'s generator) and an indexed one (a
``smiles:<csv>`` file), the ``--save_model`` files through both packages'
``infer --mode predict``, ``--mode encode``, and the finetune CLI.

Both packages train from the same initial task model (JAX's
``task_model_init`` trees handed to the port) and the same k-means initial
means (the rows JAX's ``batched_sample_vectors`` drew), with dropout 0 on
the f32 route.  Sizes: D = 32, 2 layers, at most 64 molecules, a 2-head
codebook of 8 codes.  The VQ picks a molecule's code by the argmax of its
similarities, and a mean-pooled embedding can sit near a tie between two
codes, where the packages' float noise (~1e-6 in the parameters after a
few steps) flips the code: with 16 codes the smallest gap in these runs
was 2.5e-5 and one validation molecule flipped; with 8 it is 3.8e-4.
Tolerances: losses and parameters to 1e-5 (f32 on both sides, sums in
another order; a bias that feeds a BatchNorm has a zero true gradient, so
AdamW moves it by up to ``lr`` a step on float noise either way, and its
running mean with it), AUCs within 0.1 points, probabilities to 1e-6.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.core import graph as jax_graph
from stemgnn_tpu.data import chem as jax_chem
from stemgnn_tpu.data import registry as jax_registry
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.models import task as jax_task
from stemgnn_tpu.nn.encoder import encoder_init
from stemgnn_tpu.train import finetune_loop as jax_ft
from stemgnn_tpu.utils import checkpoint as jax_ckpt
from stemgnn_tpu.utils import metrics as jax_metrics
from stemgnn_tpu.vq import codebook as jax_cb
from stemgnn_tpu.vq import vq_init
from stemgnn_tpu_torch import finetune as port_cli
from stemgnn_tpu_torch import infer as port_infer_cli
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.core import graph as port_graph
from stemgnn_tpu_torch.data import registry as port_registry
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.models import task as port_task
from stemgnn_tpu_torch.train import finetune_loop as port_ft
from stemgnn_tpu_torch.utils import checkpoint as port_ckpt
from stemgnn_tpu_torch.utils import metrics as port_metrics
from stemgnn_tpu_torch.utils.convert import task_model_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _mol_bundles(num_graphs=64, seed=1):
    """A materialized bundle from each package's ``mol_synthetic``
    generator (equal arrays)."""
    kw = dict(num_graphs=num_graphs, num_tasks=4, feat_dim=D, seed=seed)
    return (jax_synthetic.synthetic_graph_dataset(**kw),
            port_synthetic.synthetic_graph_dataset(**kw))


def _smiles_bundles(tmp_path, num_graphs=64):
    """An indexed bundle of a ``smiles:<csv>`` file through each registry:
    ``random_smiles`` molecules whose atom texts differ as multisets (two
    molecules alike up to node order pool to values equal up to float
    noise, and such near-ties would break unlike in the two packages'
    AUCs), 4 tasks of labels from their atom counts, 20% NaN, 80/10/10."""
    rng = np.random.default_rng(6)
    smiles, seen = [], set()
    while len(smiles) < num_graphs:
        s = port_synthetic.random_smiles(rng)
        key = tuple(sorted(jax_chem.smiles2graph(s)["node_feat"]))
        if key not in seen:
            seen.add(key)
            smiles.append(s)
    counts = np.asarray([[s.count(a) for a in "CNOS"] for s in smiles],
                        float)
    score = counts @ rng.standard_normal((4, 4))
    labels = (score > np.median(score, axis=0)).astype(float)
    labels[rng.random(labels.shape) < 0.2] = np.nan
    names = rng.choice(["train", "valid", "test"], num_graphs,
                       p=[0.8, 0.1, 0.1])
    path = str(tmp_path / "mols.csv")
    with open(path, "w") as f:
        f.write("smiles,split,t0,t1,t2,t3\n")
        for s, sp, lab in zip(smiles, names, labels):
            f.write(",".join([s, sp] + ["" if np.isnan(v) else str(int(v))
                                        for v in lab]) + "\n")
    name = f"smiles:{path}"
    return (jax_registry.load_dataset(name, feat_dim=D),
            port_registry.load_dataset(name, feat_dim=D), name)


def _jax_cfg(**kw):
    base = dict(
        encoder=jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="batch", dropout=0.0),
        vq=jcfg.VQConfig(dim=D, codebook_size=8, codebook_dim=D, heads=2,
                         commitment_weight=0.25, kmeans_init=True),
        task="graph", num_classes=4, epochs=2, early_stop=100, lr=1e-3,
        repeat=1, batch_size=16, dataset="mol_synthetic")
    base.update(kw)
    return jcfg.FinetuneConfig(**base)


def _port_cfg(cfg):
    fields = {f.name for f in dataclasses.fields(pcfg.FinetuneConfig)}
    return pcfg.from_dict(pcfg.FinetuneConfig(), {
        "encoder": vars(cfg.encoder).copy(), "vq": vars(cfg.vq).copy(),
        **{k: v for k, v in vars(cfg).items()
           if k in fields and k not in ("encoder", "vq")}})


# ------------------------------------------------------------- batching

def _same_graph(gp, gj, fields):
    for f in fields:
        a, b = getattr(gp, f), getattr(gj, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        assert np.array_equal(a, np.asarray(b)), f
    assert int(gp.n_graph) == int(gj.n_graph)
    assert int(gp.n_node) == int(gj.n_node)
    assert int(gp.n_edge) == int(gj.n_edge)


GRAPH_FIELDS = ("node_feat", "senders", "receivers", "node_mask",
                "edge_mask", "edge_feat", "node_graph_id")
INDEXED_FIELDS = ("node_ids", "senders", "receivers", "node_mask",
                  "edge_mask", "xe_ids", "node_graph_id")


def test_batches_equal_jax(tmp_path):
    """``batch_graphs`` / ``batch_indexed_graphs`` with and without pad
    sizes, ``pad_graph`` of a batch, and every batch of ``_batch_graph_list`` over a shuffled train
    split (``default_rng(7)`` on both sides, a short last batch): fields,
    padded graph ids, labels padded with NaN rows, ``n_real``."""
    (gj, lj, sj), (gp, lp, sp) = _mol_bundles()
    _same_graph(port_graph.batch_graphs(gp[:5]),
                jax_graph.batch_graphs(gj[:5]), GRAPH_FIELDS)
    _same_graph(port_graph.batch_graphs(gp[:5], 256, 512),
                jax_graph.batch_graphs(gj[:5], 256, 512), GRAPH_FIELDS)
    _same_graph(port_graph.pad_graph(port_graph.batch_graphs(gp[:5]),
                                     160, 640),
                jax_graph.pad_graph(jax_graph.batch_graphs(gj[:5]), 160,
                                    640), GRAPH_FIELDS)
    with pytest.raises(ValueError):
        port_graph.pad_graph(port_graph.batch_graphs(gp[:5]), 8, 640)
    (ij, yj, tj), (ip, yp, tp), _ = _smiles_bundles(tmp_path)
    _same_graph(port_graph.batch_indexed_graphs(ip.items[:7], 128, 256),
                jax_graph.batch_indexed_graphs(ij.items[:7], 128, 256),
                INDEXED_FIELDS)
    for (bj, labj, split_j), (bp, labp, split_p), fields in (
            ((gj, lj, sj), (gp, lp, sp), GRAPH_FIELDS),
            ((ij, yj, tj), (ip, yp, tp), INDEXED_FIELDS)):
        idx = np.where(split_p["train"])[0]
        assert np.array_equal(idx, np.where(split_j["train"])[0])
        rj, rp = np.random.default_rng(7), np.random.default_rng(7)
        ij_, ip_ = idx.copy(), idx.copy()
        rj.shuffle(ij_)
        rp.shuffle(ip_)
        got = list(port_ft._batch_graph_list(bp, labp, ip_, 16))
        want = list(jax_ft._batch_graph_list(bj, labj, ij_, 16))
        assert len(got) == len(want) == -(-len(idx) // 16)
        for (g1, l1, n1), (g2, l2, n2) in zip(got, want):
            _same_graph(g1, g2, fields)
            assert n1 == n2 and np.array_equal(l1, l2, equal_nan=True)
            assert g1.num_nodes_padded % 512 == 0
        assert got[-1][2] == len(idx) % 16 or len(idx) % 16 == 0
        assert np.isnan(got[-1][1][got[-1][2]:]).all()


# ----------------------------------------------------- pooling and loss

def _batch_pair(n_graphs, slots):
    (gj, _, _), (gp, _, _) = _mol_bundles(num_graphs=16)
    return (jax_graph.batch_graphs(gj[:n_graphs], 512, 2048),
            port_graph.batch_graphs(gp[:n_graphs], 512, 2048), slots)


@pytest.mark.parametrize("pool", ["mean", "sum", "max"])
@pytest.mark.parametrize("n_graphs", [16, 11], ids=["full", "short"])
def test_pool_graph_matches_jax(pool, n_graphs):
    """Pooled rows and the gradient of a weighted sum of them, over a full
    batch (padded nodes carry the out-of-range id) and a short one (padded
    nodes carry the id of the first empty slot, which pools to zeros)."""
    gj, gp, slots = _batch_pair(n_graphs, 16)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((gp.num_nodes_padded, D)).astype(np.float32)
    w = rng.standard_normal((slots, D)).astype(np.float32)

    def f(zz):
        return jnp.sum(jax_task.pool_graph(zz, gj, pool, slots) * w)
    want, gwant = jax.value_and_grad(f)(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    out = port_task.pool_graph(zt, gp, pool, slots)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jax_task.pool_graph(jnp.asarray(z), gj, pool, slots)), **TOL)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gwant), **TOL)
    assert not out[n_graphs:].detach().any()


def test_multitask_bce_matches_jax():
    """``activation_loss("multi")`` and ``multitask_bce`` with NaN labels,
    an all-NaN row, padded graphs masked out, and no mask at all: values
    and logit gradients."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((8, 2, 5)).astype(np.float32) * 3
    lab = (rng.random((8, 5)) > 0.5).astype(float)
    lab[rng.random(lab.shape) < 0.3] = np.nan
    lab[2] = np.nan
    y = np.nan_to_num(lab * 2.0 - 1.0).astype(np.float32)
    valid = ~np.isnan(lab)
    for mask in (np.arange(8) < 6, None):
        def f(x):
            return jax_task.activation_loss(
                x, jnp.asarray(y), "multi",
                None if mask is None else jnp.asarray(mask),
                jnp.asarray(valid))
        want, gwant = jax.value_and_grad(f)(jnp.asarray(logits))
        xt = torch.from_numpy(logits).requires_grad_(True)
        got = port_task.activation_loss(
            xt, torch.from_numpy(y), "multi",
            None if mask is None else torch.from_numpy(mask),
            torch.from_numpy(valid))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gwant), **TOL)
    none = np.zeros_like(valid)
    assert float(port_task.multitask_bce(
        torch.from_numpy(logits[:, 0]), torch.from_numpy(y),
        torch.from_numpy(none))) == 0.0
    with pytest.raises(ValueError):
        port_task.activation_loss(torch.zeros(2, 1, 3), None, "pairs")


# ------------------------------------------------------------------ AUC

def _auc_cases():
    rng = np.random.default_rng(5)
    y = (rng.random((40, 6)) > 0.5).astype(float)
    y[rng.random(y.shape) < 0.3] = np.nan
    y[:, 1] = np.where(np.isnan(y[:, 1]), np.nan, 1.0)   # one class only
    y[:, 2] = np.nan                                     # no label
    pred = rng.standard_normal((40, 6)).astype(np.float32)
    ties = np.round(pred, 0)                             # many ties
    all_nan = np.full((10, 3), np.nan)
    return [(pred, y), (ties, y),
            (rng.standard_normal((10, 3)).astype(np.float32), all_nan)]


def test_auc_matches_jax():
    """The host ``eval_auc`` / ``evaluate`` and the device
    ``device_multitask_auc`` against JAX's on ties, on tasks missing a class
    and on the all-NaN case (NaN on both sides)."""
    for pred, y in _auc_cases():
        want = jax_metrics.eval_auc(pred, y)
        got = port_metrics.eval_auc(pred, y)
        assert (np.isnan(got) and np.isnan(want)) or got == want
        assert port_metrics.evaluate(pred, y, None, "graph") == \
            pytest.approx(jax_metrics.evaluate(pred, y, None, "graph"),
                          nan_ok=True)
        yv, v = np.nan_to_num(y).astype(np.float32), ~np.isnan(y)
        dwant = float(jax_metrics.device_multitask_auc(
            jnp.asarray(pred), jnp.asarray(yv), jnp.asarray(v)))
        dgot = float(port_metrics.device_multitask_auc(
            torch.from_numpy(pred), torch.from_numpy(yv),
            torch.from_numpy(v)))
        if np.isnan(want):
            assert np.isnan(dwant) and np.isnan(dgot)
        else:
            assert abs(dgot - dwant) <= 1e-6 and abs(dgot - got) <= 1e-6


# ---------------------------------------------------- runs against JAX

def _run_both(cfg, bundle_j, bundle_p, monkeypatch, save_dir=None):
    """JAX's ``run_finetune`` and the port's from the same initial task
    model and k-means initial means; returns (JAX's logged rows, the port's
    logged rows, the port's result)."""
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

    def init_rec(*a, **k):
        out = real_init(*a, **k)
        inits.append(_np(out))
        return out

    def sample_rec(*a, **k):
        out = real_sample(*a, **k)
        means.append(np.asarray(out))
        return out
    monkeypatch.setattr(jax_task, "task_model_init", init_rec)
    monkeypatch.setattr(jax_cb, "batched_sample_vectors", sample_rec)
    path = (lambda who: "" if save_dir is None
            else str(save_dir / f"{who}.npz"))
    jax_ft.run_finetune(bundle_j, cfg, save_model_to=path("jax"))
    assert len(inits) == 1 and len(means) == int(cfg.use_vq)
    pc = _port_cfg(cfg)
    monkeypatch.setattr(port_ft, "task_model_init",
                        lambda *a, **k: task_model_from_jax(*inits[0], pc))
    if means:
        real_km = port_ft.maybe_kmeans_init_vq
        monkeypatch.setattr(
            port_ft, "maybe_kmeans_init_vq",
            lambda model, cfg_, g, **k: real_km(
                model, cfg_, g, means=torch.from_numpy(means[0].copy())))
    res = port_ft.run_finetune(bundle_p, pc, device="cpu",
                               save_model_to=path("port"))
    return rows["jax"], rows["port"], res


def _check_rows(want, got, tag):
    """Per-epoch losses to 1e-5, AUCs within 0.1 points, the same epochs
    logged and the same best epoch."""
    assert [r[0] for r in got] == [r[0] for r in want], tag
    for (e, lw, rw), (_, lg, rg) in zip(want, got):
        for k in ("loss", "act_loss", "jac_loss", "env_loss"):
            np.testing.assert_allclose(lg[k], lw[k], **TOL,
                                       err_msg=f"{tag} epoch {e} {k}")
        for k in ("train", "val", "test"):
            if np.isnan(rw[k]):
                assert np.isnan(rg[k]), (tag, e, k)
            else:
                assert abs(rg[k] - rw[k]) <= 0.1, (tag, e, k, rg[k], rw[k])
    best = [int(np.nanargmax([r[2]["val"] for r in rows]))
            for rows in (want, got)]
    assert best[0] == best[1], tag
    assert not np.isnan(want[best[0]][2]["val"]), tag


def _noise(path):
    """Leaves that move on float noise (see the module docstring)."""
    return ("lin_l" in path and "'b'" in path) or (
        "norms" in path and "'mean'" in path)


def _check_trees(path_j, path_p, atol_noise):
    tj, tp = port_ckpt.load_pytree(path_j), port_ckpt.load_pytree(path_p)
    lj, lp = _leaves(tj), _leaves(tp)
    assert set(lj) == set(lp)
    for path, leaf in lj.items():
        np.testing.assert_allclose(
            lp[path], leaf, rtol=1e-5,
            atol=atol_noise if _noise(path) else 1e-5, err_msg=path)


@pytest.mark.parametrize("bundle", ["materialized", "indexed"])
def test_one_graph_step_matches_jax(bundle, monkeypatch, tmp_path):
    """One training step (the whole train split in one batch, one epoch)
    from JAX's initial weights: the loss parts to 1e-5 and the saved
    parameters and BatchNorm statistics after the step to 1e-5."""
    if bundle == "materialized":
        (bj, bp), name = _mol_bundles(num_graphs=40), "mol_synthetic"
    else:
        bj, bp, name = _smiles_bundles(tmp_path, num_graphs=40)
    cfg = _jax_cfg(epochs=1, batch_size=40, dataset=name)
    want, got, res = _run_both(cfg, bj, bp, monkeypatch, tmp_path)
    assert res["history"][0]["batches"] == 1
    _check_rows(want, got, f"one step {bundle}")
    _check_trees(str(tmp_path / "jax.npz"), str(tmp_path / "port.npz"),
                 2.1 * cfg.lr)


RUNS = {
    "default": dict(epochs=2),
    "eval_every2_no_train_auc_eval64": dict(epochs=3, eval_every=2,
                                            eval_train_auc=False,
                                            eval_batch_size=64),
    # the indexed bundle's few atom texts pool every molecule to one code
    # of this small codebook (AUC 50 on both sides); without the VQ its
    # AUCs move
    "no_vq": dict(epochs=2, use_vq=False),
}


@pytest.mark.parametrize("opts", list(RUNS))
@pytest.mark.parametrize("bundle", ["materialized", "indexed"])
def test_run_finetune_graph_matches_jax(bundle, opts, monkeypatch, tmp_path):
    """``run_finetune(task="graph")`` against JAX's: the logged rows (which
    epochs evaluate, losses, AUCs, the best epoch); the evaluation route
    (the indexed bundle's device AUC, the materialized bundle's host AUC);
    the history's host times a batch."""
    if bundle == "materialized":
        (bj, bp), name = _mol_bundles(), "mol_synthetic"
    else:
        bj, bp, name = _smiles_bundles(tmp_path)
    cfg = _jax_cfg(dataset=name, **RUNS[opts])
    want, got, res = _run_both(cfg, bj, bp, monkeypatch)
    _check_rows(want, got, f"{bundle} {opts}")
    assert res["eval_route"].startswith(
        "device AUC" if bundle == "indexed" else "host AUC")
    n_train = int(np.asarray(bp[2]["train"]).sum())
    assert len(res["history"]) == cfg.epochs
    for h in res["history"]:
        assert h["batches"] == -(-n_train // 16)
        assert h["host/sample_ms"] > 0 and h["host/transfer_ms"] > 0
        assert "device_ms" not in h            # CUDA events only on CUDA
    if not cfg.eval_train_auc:
        assert all(np.isnan(r[2]["train"]) for r in got)


def _load_jax_infer():
    spec = importlib.util.spec_from_file_location(
        "repo_infer", os.path.join(ROOT, "infer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("bundle", ["materialized", "indexed"])
def test_saved_models_predict_across_packages(bundle, monkeypatch,
                                              tmp_path):
    """Each package's ``--save_model`` file through the other's ``infer
    --mode predict`` (and its own): per-molecule probabilities to 1e-6,
    logits and ``pred`` alike; the meta's keys agree; the port's file
    predicts the sigmoid of its best epoch's evaluation logits."""
    if bundle == "materialized":
        (bj, bp), name = _mol_bundles(), "mol_synthetic"
    else:
        bj, bp, name = _smiles_bundles(tmp_path)
    cfg = _jax_cfg(dataset=name)
    _, _, res = _run_both(cfg, bj, bp, monkeypatch, tmp_path)
    files = {"jax": str(tmp_path / "jax.npz"),
             "port": str(tmp_path / "port.npz")}
    metas = {k: port_ckpt.load_meta(v) for k, v in files.items()}
    assert set(metas["jax"]) == set(metas["port"]) == {
        "config", "best_val", "task", "dataset"}
    assert metas["port"]["task"] == "graph"
    assert metas["port"]["config"]["num_classes"] == 4
    monkeypatch.setattr(jax_registry, "load_dataset", lambda *a, **k: bj)
    monkeypatch.setattr(port_infer_cli, "load_dataset", lambda *a, **k: bp)
    jax_cli = _load_jax_infer()
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
        assert set(a.files) == set(b.files) == {"probs", "logits", "pred"}
        assert b["probs"].shape == (len(bp[0]), 4)
        np.testing.assert_allclose(b["probs"], a["probs"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(b["logits"], a["logits"], **TOL)
        assert b["pred"].dtype == a["pred"].dtype
        assert (b["pred"] != a["pred"]).sum() <= 1
        probs[owner] = b["probs"]
    for k, logits in res["best_pred"].items():
        rows = np.where(np.asarray(bp[2][k]))[0]
        np.testing.assert_allclose(probs["port"][rows],
                                   1.0 / (1.0 + np.exp(-logits)), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_encode_mode_matches_jax(monkeypatch, tmp_path):
    """``infer --mode encode`` on a molecule bundle from a JAX-format
    pretrain checkpoint: the pooled embeddings and their quantized form to
    1e-5 and the codes equal to JAX's ``graph_task_encode``."""
    _, bp, name = _smiles_bundles(tmp_path)
    cfg = _jax_cfg()
    ke, kv = jax.random.split(jax.random.PRNGKey(8))
    ep, es = encoder_init(ke, cfg.encoder)
    vp, vs = vq_init(kv, cfg.vq)
    ckpt_dir = tmp_path / "ckpt"
    jax_ckpt.save_pytree(str(ckpt_dir / "encoder_50.npz"),
                         {"params": ep, "state": es})
    jax_ckpt.save_pytree(str(ckpt_dir / "vq_50.npz"),
                         {"params": vp, "state": vs})
    import json
    with open(ckpt_dir / "config.json", "w") as f:
        json.dump({"encoder": {"hidden_dim": D, "num_layers": 2,
                               "normalize": "batch"},
                   "vq": {"codebook_size": 8, "codebook_dim": D,
                          "heads": 2}}, f)
    want = jax_ft.graph_task_encode(
        bp[0], cfg, {"encoder": ep, "vq": vp}, {"encoder": es, "vq": vs})
    monkeypatch.setattr(port_infer_cli, "load_dataset", lambda *a, **k: bp)
    out = str(tmp_path / "enc.npz")
    port_infer_cli.main(["--finetune_dataset", name, "--feat_dim", str(D),
                         "--pretrain_path", str(ckpt_dir), "--out", out,
                         "--device", "cpu"])
    got = np.load(out)
    assert set(got.files) == {"embeddings", "quantized", "codes"}
    np.testing.assert_allclose(got["embeddings"], np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got["quantized"], np.asarray(want[1]), **TOL)
    assert np.array_equal(got["codes"], np.asarray(want[2]))
    assert got["codes"].shape == (len(bp[0]), 2)


# --------------------------------------------------------------- the CLI

def _load_jax_cli():
    spec = importlib.util.spec_from_file_location(
        "repo_finetune", os.path.join(ROOT, "finetune.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("name", ["mol_synthetic", "chemhiv", "chempcba"])
def test_graph_presets_namespace_equals_jax(name, monkeypatch):
    """``--use_params`` for the graph presets of ``configs/finetune.yaml``:
    the port's namespace equals JAX's (stopped at its sweep round-trip)."""
    from stemgnn_tpu.utils import jax_cache, observability
    seen = {}

    def stop(args, *a, **k):
        seen["args"] = args
        raise _Parsed
    monkeypatch.setattr(observability, "apply_wandb_sweep_config", stop)
    monkeypatch.setattr(jax_cache, "enable_persistent_cache",
                        lambda *a, **k: None)
    argv = ["--use_params", "--finetune_dataset", name, "--eval_every", "2",
            "--debug"]
    monkeypatch.setattr(sys, "argv", ["finetune.py", *argv])
    with pytest.raises(_Parsed):
        _load_jax_cli().main()
    got = vars(port_cli.parse(argv))
    assert got.pop("device") is None
    assert got == vars(seen["args"])
    assert got["normalize"] == "batch" and got["batch_size"] in (64, 1024)


def test_cli_chemhiv_raises_and_eval_bf16_is_refused(monkeypatch):
    with pytest.raises(FileNotFoundError) as want:
        jax_registry.load_dataset("chemhiv", feat_dim=8)
    with pytest.raises(FileNotFoundError) as got:
        port_cli.main(["--use_params", "--finetune_dataset", "chemhiv",
                       "--device", "cpu", "--debug"])
    assert str(got.value) == str(want.value)
    # --eval_bf16 1 was refused (ROADMAP Queue 1 item 4); it is accepted
    # now and reaches run_finetune as JAX's finetune.py:249 passes it
    seen = {}

    def stop(ds, cfg, *a, **k):
        seen["cfg"] = cfg
        raise _Parsed
    monkeypatch.setattr(port_cli, "run_finetune", stop)
    with pytest.raises(_Parsed):
        port_cli.main(["--finetune_dataset", "mol_synthetic", "--eval_bf16",
                       "1", "--device", "cpu", "--debug"])
    assert seen["cfg"].eval_bf16 and seen["cfg"].task == "graph"


def test_finetune_cli_graph_task_on_the_cpu():
    """``python -m stemgnn_tpu_torch.finetune --device cpu
    --finetune_dataset mol_synthetic --epochs 1`` (one split) exits 0 at the
    reference's width and reports the AUC."""
    proc = subprocess.run(
        [sys.executable, "-m", "stemgnn_tpu_torch.finetune", "--device",
         "cpu", "--finetune_dataset", "mol_synthetic", "--epochs", "1",
         "--repeat", "1", "--debug"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "final/test:" in proc.stdout
    assert "host AUC, cached batches" in proc.stdout
