"""The port's robustness evaluations against the JAX package on the CPU:
the ``arxiv_synthetic_fragile`` dataset, the OOD buckets and stratified
splits, the two perturbations (all bit for bit), the training scaffold
(``eval/runner.train_node_with_buckets``: best epoch, accuracies and
snapshot), the re-evaluation of a snapshot on perturbed graphs, and the
five ``stemgnn_tpu_torch.scripts`` evaluation scripts (their JSON keys
against the JAX scripts', the TSV, the refusals).

JAX's runner runs with ``epoch_chunk=0`` (one jitted step an epoch; its
chunked scan trains past ``cfg.epochs``, which the port does not copy) and
dropout 0 (the two packages cannot share dropout draws), on the plain f32
graph (its CPU path).  The port starts from JAX's initial weights, handed
over through ``utils/convert.task_model_from_jax``, with a VQ that is
initted already.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.data import registry as jax_registry
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.eval import buckets as jb
from stemgnn_tpu.eval import perturb as jp
from stemgnn_tpu.eval import runner as jr
from stemgnn_tpu.models import task as jax_task
from stemgnn_tpu.nn.encoder import encoder_init
from stemgnn_tpu.train.finetune_loop import _merge
from stemgnn_tpu.vq.quantize import vq_init
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import registry as port_registry
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.eval import buckets as pb
from stemgnn_tpu_torch.eval import perturb as pp
from stemgnn_tpu_torch.eval import runner as pr
from stemgnn_tpu_torch.models.task import encode
from stemgnn_tpu_torch.scripts import _common as port_common
from stemgnn_tpu_torch.train.graph_setup import fused_full_graph
from stemgnn_tpu_torch.utils.convert import (task_model_from_jax,
                                             task_model_to_jax)
from stemgnn_tpu_torch.utils.observability import apply_wandb_sweep_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("degree_shift_ood", "homophily_shift_ood", "missing_feature",
           "random_edge_drop", "tri_objective")


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _assert_same_arrays(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what


def _assert_same_dataset(dj, dp):
    for f in ("node_text_feat", "edge_text_feat", "x", "xe", "edge_index",
              "labels"):
        _assert_same_arrays(getattr(dj, f), getattr(dp, f), f)
    assert (dj.num_classes, dj.num_tasks) == (dp.num_classes, dp.num_tasks)
    assert len(dj.splits) == len(dp.splits)
    for sj, sp in zip(dj.splits, dp.splits):
        assert list(sj) == list(sp)
        for k in sj:
            _assert_same_arrays(sj[k], sp[k], k)


# --------------------------------------------------------------- the data


@pytest.mark.parametrize("num_nodes", [2_000, 20_000])
def test_fragile_dataset_equals_jax(num_nodes):
    """The registry entry with JAX's parameters (16 signal dims, half the
    nodes signal-free, 8,000 / 4,000 train / val nodes a split), at a small
    ``num_nodes``: every array bit for bit."""
    kw = dict(num_nodes=num_nodes, feat_dim=16, seed=3)
    dj = jax_registry.load_dataset("arxiv_synthetic_fragile", **kw)
    dp = port_registry.load_dataset("arxiv_synthetic_fragile", **kw)
    _assert_same_dataset(dj, dp)
    assert dp.num_classes == 40 and dp.num_nodes == num_nodes


@pytest.fixture(scope="module")
def fragile():
    """The fragile graph at 2,000 nodes with a few self-loops and
    duplicate edges added, and features with a zero row and a nan row (the
    homophily statistic's invalid nodes)."""
    ds = port_registry.load_dataset("arxiv_synthetic_fragile",
                                    num_nodes=2_000, feat_dim=16, seed=3)
    extra = np.array([[5, 9, 9, 11, 11], [5, 9, 12, 40, 40]])
    edge_index = np.concatenate([ds.edge_index, extra], axis=1)
    x = ds.node_features().copy()
    x[17] = 0.0
    x[23, 3] = np.nan
    return ds, edge_index, x


def test_degree_buckets_equal_jax(fragile):
    ds, edge_index, _ = fragile
    got = pb.compute_degree_buckets(edge_index, ds.num_nodes)
    want = jb.compute_degree_buckets(edge_index, ds.num_nodes)
    _assert_same_arrays(got[0], want[0], "deg")
    assert got[1] == want[1]
    assert list(got[2]) == list(want[2]) == ["OOD-low", "ID", "OOD-high"]
    for k in want[2]:
        _assert_same_arrays(got[2][k], want[2][k], k)


@pytest.mark.parametrize("chunk", [7, 100_000])
def test_chunked_similarity_equals_jax(fragile, chunk):
    """The neighbour-similarity statistic over chunks of edges (7, far
    fewer than this graph's 56,000 undirected edges; 100,000, all of them
    in one chunk; the default 2,048 in the bucket tests below) against
    JAX's unchunked one, bit for bit, with its counts."""
    ds, edge_index, x = fragile
    got = pb._neighbor_feature_similarity(x, edge_index, ds.num_nodes,
                                          edge_chunk=chunk)
    want = jb._neighbor_feature_similarity(x, edge_index, ds.num_nodes)
    _assert_same_arrays(got[0], want[0], "stat")
    _assert_same_arrays(got[1], want[1], "valid nodes")
    assert got[2:] == want[2:]


@pytest.mark.parametrize("kind", ["homophily", "alignment"])
def test_similarity_buckets_equal_jax(fragile, kind):
    """The homophily and alignment buckets, bounds and counts (the
    similarity over the default chunks of 2,048 edges, fewer than this
    graph's) against JAX's, bit for bit."""
    ds, edge_index, x = fragile
    fn = "compute_homophily_buckets" if kind == "homophily" else \
        "compute_alignment_buckets"
    got = getattr(pb, fn)(x, edge_index, ds.num_nodes)
    want = getattr(jb, fn)(x, edge_index, ds.num_nodes)
    _assert_same_arrays(got[0], want[0], "stat")
    assert got[1] == want[1]
    assert list(got[2]) == list(want[2])
    for k in want[2]:
        _assert_same_arrays(got[2][k], want[2][k], k)
    assert got[3:] == want[3:]
    assert got[4] == 1 + 1          # the zero row and the nan row
    assert edge_index.shape[1] > pb.SIM_EDGE_CHUNK


def test_stratified_split_and_counts_equal_jax(fragile):
    ds, edge_index, _ = fragile
    _, _, buckets = pb.compute_degree_buckets(edge_index, ds.num_nodes)
    for seed in range(4):
        got = pb.stratified_split(buckets["ID"], ds.labels, seed)
        want = jb.stratified_split(buckets["ID"], ds.labels, seed)
        for g, w in zip(got, want):
            _assert_same_arrays(g, w)
    for size in range(3, 120):
        assert pb.determine_split_counts(size) == \
            jb.determine_split_counts(size)
    for mod in (pb, jb):
        with pytest.raises(RuntimeError):
            mod.determine_split_counts(2)


# ------------------------------------------------------- the perturbations


@pytest.fixture(scope="module")
def pert_ds():
    """The fragile graph at 20,000 nodes, where the split holds train, val
    and test nodes, on both sides."""
    kw = dict(num_nodes=20_000, feat_dim=16, seed=5)
    return (jax_registry.load_dataset("arxiv_synthetic_fragile", **kw),
            port_registry.load_dataset("arxiv_synthetic_fragile", **kw))


@pytest.mark.parametrize("perturb", ["test", "valtest", "all"])
@pytest.mark.parametrize("prob,alpha,noise_seed", [
    (0.0, 0.0, None), (0.4, 0.0, None), (1.0, 0.0, None), (0.4, 0.5, None),
    (0.6, 0.3, 11)])
def test_missing_features_equal_jax(pert_ds, perturb, prob, alpha,
                                    noise_seed):
    dj, dp = pert_ds
    kw = dict(missing_prob=prob, seed=4, perturb=perturb,
              relative_noise_alpha=alpha, relative_noise_seed=noise_seed)
    got = pp.apply_missing_features(dp, dp.splits[0], **kw)
    want = jp.apply_missing_features(dj, dj.splits[0], **kw)
    _assert_same_dataset(want, got)
    assert got.node_text_feat.shape == (dp.num_nodes, 16)


@pytest.mark.parametrize("perturb", ["test", "valtest", "val_test", "all"])
@pytest.mark.parametrize("mode", ["per_undirected", "per_edge"])
@pytest.mark.parametrize("prob", [0.0, 0.3, 1.0])
def test_edge_drops_equal_jax(pert_ds, perturb, mode, prob):
    """Both modes over every scope; at p = 1 the never-drop-all guard keeps
    one candidate edge (pair) on both sides."""
    dj, dp = pert_ds
    kw = dict(drop_prob=prob, seed=4, perturb=perturb, drop_mode=mode)
    got = pp.apply_random_edge_drops(dp, dp.splits[0], **kw)
    want = jp.apply_random_edge_drops(dj, dj.splits[0], **kw)
    _assert_same_dataset(want, got)
    if prob == 1.0:
        s = dp.splits[0]
        scope = (np.ones(dp.num_nodes, bool) if perturb == "all" else
                 s["test"] if perturb == "test" else s["valid"] | s["test"])
        src, dst = got.edge_index
        left = int((scope[src] | scope[dst]).sum())
        assert left == (1 if mode == "per_edge" else 2)


def test_perturbations_refuse_bad_options(pert_ds):
    _, dp = pert_ds
    split = dp.splits[0]
    with pytest.raises(ValueError):
        pp.apply_missing_features(dp, split, missing_prob=1.5)
    with pytest.raises(ValueError):
        pp.apply_random_edge_drops(dp, split, perturb="train")
    with pytest.raises(ValueError):
        pp.apply_random_edge_drops(dp, split, drop_mode="per_node")


# ---------------------------------------------------------- the runner

D, C, SEED, EPOCHS, LR = 16, 5, 2, 4, 1e-3


def _run_datasets():
    kw = dict(num_nodes=500, num_classes=C, feat_dim=D, avg_degree=8,
              pref_attach=1.1, num_splits=1, seed=3)
    return (jax_synthetic.synthetic_node_dataset(**kw),
            port_synthetic.synthetic_node_dataset(**kw))


def _jax_cfg():
    """The scripts' configuration at width D (no normalization), dropout
    0, 2 heads of 16 codes (the VQ projects), no epoch chunks; hub sizes
    that give the port's forced layout hub blocks on this graph."""
    return jcfg.FinetuneConfig(
        encoder=jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="none", dropout=0.0),
        vq=jcfg.VQConfig(dim=D, codebook_size=16, codebook_dim=D, heads=2,
                         commitment_weight=0.25),
        task="node", num_classes=C, epochs=EPOCHS, early_stop=100, lr=LR,
        epoch_chunk=0, hub_size=64, sc_hub_size=64)


def _port_cfg(cfg):
    return pcfg.from_dict(pcfg.FinetuneConfig(), {
        "encoder": vars(cfg.encoder).copy(), "vq": vars(cfg.vq).copy(),
        **{k: getattr(cfg, k) for k in ("task", "num_classes", "lr",
                                        "epochs", "early_stop", "hub_size",
                                        "sc_hub_size")}})


@pytest.fixture(scope="module")
def jax_run():
    """JAX's runner on degree buckets with a stratified split inside ID,
    from a pretrained bundle whose VQ is initted; the initial task-model
    trees JAX builds inside it, rebuilt the same way."""
    cfg = _jax_cfg()
    ds_j, ds_p = _run_datasets()
    _, _, buckets = jb.compute_degree_buckets(ds_j.edge_index, ds_j.num_nodes)
    tr, va, te = jb.stratified_split(buckets["ID"], ds_j.labels, seed=SEED)
    split = {"train": tr, "valid": va, "test": te}
    ke, kv = jax.random.split(jax.random.PRNGKey(5))
    ep, es = encoder_init(ke, cfg.encoder)
    vp, vs = vq_init(kv, cfg.vq)
    vs = dict(vs, initted=jnp.asarray(True))
    bundle = _to_np({"encoder_params": ep, "encoder_state": es,
                     "vq_params": vp, "vq_state": vs})
    best = jr.train_node_with_buckets(ds_j, cfg, split, buckets,
                                      pretrained=bundle, seed=SEED)
    _, k_init = jax.random.split(jax.random.PRNGKey(SEED))
    params, state = jax_task.task_model_init(
        k_init, cfg, encoder_params=bundle["encoder_params"],
        vq_params=bundle["vq_params"], encoder_state=bundle["encoder_state"],
        vq_state=bundle["vq_state"])
    return dict(cfg=cfg, ds_j=ds_j, ds_p=ds_p, split=split, buckets=buckets,
                best=best, init=(_to_np(params), _to_np(state)))


def _within_one_node(got, want, masks, tag):
    """Accuracies x100 of each mask within one node of it; returns the
    gaps, printed."""
    gaps = {}
    for k, w in want.items():
        m = np.asarray(masks[k])
        size = int(m.sum()) if m.dtype == bool else m.size
        gaps[k] = abs(got[k] - w)
        assert gaps[k] <= 100.0 / size + 1e-9, (tag, k, got[k], w, size)
    print(f"{tag}: accuracy gaps {gaps}")
    return gaps


@pytest.mark.parametrize("route", ["plain_f32", "layout_bf16",
                                   "layout_gwin_off"])
def test_runner_matches_jax(jax_run, route):
    """``train_node_with_buckets`` from JAX's initial weights: the same best
    epoch; each split's and bucket's accuracy within one node of its mask;
    the snapshot's parameters to the tolerances of one finetune step
    (``tests/test_torch_port_train.py``): 1e-5 on the f32 route; on the
    layout routes (bf16 messages; the tails through kernel 2, or with
    ``gwin="off"`` gathered and summed by kernel 1) a parameter whose
    gradient flips sign can move 2 * lr the other way in each AdamW step,
    so 2.1 * lr for each step up to the best epoch.  The frozen VQ stays as
    it was, bit for bit."""
    cfg, ds_p = jax_run["cfg"], jax_run["ds_p"]
    pc = _port_cfg(cfg)
    model = task_model_from_jax(*jax_run["init"], pc)
    layout = route != "plain_f32"
    gwin = "off" if route == "layout_gwin_off" else "auto"
    best = pr.train_node_with_buckets(
        ds_p, pc, jax_run["split"], jax_run["buckets"], seed=SEED,
        device="cpu", use_layout=layout, gwin=gwin, model=model)
    want = jax_run["best"]
    if layout:
        lay = fused_full_graph(ds_p, pc, device="cpu", use_layout=True,
                               gwin=gwin).layout
        assert lay.hub_r is not None
        assert lay.hub_r.tail.use_gwin_r == (gwin == "auto")
    print(f"{route}: best epoch {best['epoch']} (JAX {want['epoch']}), "
          f"val {best['val']:.4f} (JAX {want['val']:.4f})")
    assert best["epoch"] == want["epoch"]
    assert list(best["split_acc"]) == list(want["split_acc"])
    assert list(best["bucket_acc"]) == list(want["bucket_acc"])
    _within_one_node(best["split_acc"], want["split_acc"], jax_run["split"],
                     f"{route} splits")
    _within_one_node(best["bucket_acc"], want["bucket_acc"],
                     jax_run["buckets"], f"{route} buckets")

    got_p, _ = task_model_to_jax(pr.snapshot_model(best))
    want_p = _to_np(_merge(want["trainable"], want["frozen"]))
    tol = (dict(rtol=0, atol=2.1 * LR * (want["epoch"] + 1)) if layout
           else dict(rtol=1e-5, atol=1e-5))
    for part in ("encoder", "decoder"):
        got_l, want_l = _leaves(got_p[part]), _leaves(want_p[part])
        assert set(got_l) == set(want_l)
        for path, leaf in want_l.items():
            np.testing.assert_allclose(got_l[path], leaf, **tol,
                                       err_msg=f"{part} {path}")
    init_vq = _leaves(jax_run["init"][0]["vq"])
    for path, leaf in _leaves(got_p["vq"]).items():
        assert np.array_equal(leaf, init_vq[path]), path
    assert best["stats"]["layout_s"] and "step_ms" not in best["stats"]


def _port_best_from_jax(want, pc):
    """JAX's best snapshot in the port's form."""
    model = task_model_from_jax(_to_np(_merge(want["trainable"],
                                              want["frozen"])),
                                _to_np(want["state"]), pc)
    return dict(model=model, state={k: v.clone() for k, v in
                                    model.state_dict().items()},
                masks=want["masks"], bucket_masks=want["bucket_masks"],
                y=want["y"], stats={})


def _perturbed(kind, ds, split, mod):
    if kind == "missing_features":
        return mod.apply_missing_features(ds, split, missing_prob=0.4,
                                          seed=SEED, perturb="all")
    return mod.apply_random_edge_drops(ds, split, drop_prob=0.3, seed=SEED,
                                       perturb="all")


@pytest.mark.parametrize("kind", ["missing_features", "edge_drops"])
def test_reevaluation_on_perturbed_graphs_matches_jax(jax_run, kind):
    """``evaluate_snapshot_on`` of JAX's best snapshot on a perturbed graph:
    the class probabilities to 1e-5 on the f32 route and each split's and
    bucket's accuracy within one node of JAX's; on the forced layout route
    (the perturbed graph's own layout, bf16 messages) the embeddings to the
    z gate of the smoke's route checks (rtol 3e-2, atol 1e-2)."""
    cfg, want = jax_run["cfg"], jax_run["best"]
    pc = _port_cfg(cfg)
    split = jax_run["split"]
    masks = {k: jr._pad_mask(v, jax_run["ds_j"].num_nodes,
                             jax_run["ds_j"].num_nodes) for k, v in
             split.items()}
    ds_pj = _perturbed(kind, jax_run["ds_j"], masks, jp)
    ds_pp = _perturbed(kind, jax_run["ds_p"], masks, pp)
    _assert_same_dataset(ds_pj, ds_pp)

    graph = ds_pj.to_graph()
    params = _merge(want["trainable"], want["frozen"])
    z, st, _ = jax_task.encode(params, want["state"], cfg, graph,
                               training=False)
    logits, _, _ = jax_task.task_logits(params, st, cfg, z, training=False,
                                        mask=graph.node_mask)
    probs_j = np.asarray(jax.nn.softmax(jnp.mean(logits, axis=1), axis=-1))
    acc_j = jr.evaluate_snapshot_on(ds_pj, cfg, want)

    best = _port_best_from_jax(want, pc)
    n = ds_pp.num_nodes
    probs_p = pr.predict_snapshot_on(ds_pp, pc, best, use_layout=False)
    np.testing.assert_allclose(probs_p[:n], probs_j[:n], rtol=1e-5,
                               atol=1e-5)
    acc_p = pr.evaluate_snapshot_on(ds_pp, pc, best, use_layout=False)
    assert list(acc_p) == list(acc_j)
    _within_one_node(acc_p, acc_j, {**split, **jax_run["buckets"]},
                     f"re-evaluation ({kind})")
    # the forced layout route over the perturbed graph's own layout: z to
    # the z gate; the probabilities are not compared there, since a VQ code
    # choice flips where the bf16 messages move z across a tie
    probs_l = pr.predict_snapshot_on(ds_pp, pc, best, use_layout=True)
    assert probs_l.shape[1] == C and np.isfinite(probs_l).all()
    assert len(best["stats"]["layout_s"]) == 3
    g = fused_full_graph(ds_pp, pc, device="cpu", use_layout=True)
    assert g.layout.hub_r is not None
    with torch.no_grad():
        z_l = encode(pr.snapshot_model(best).eval(), g)
    np.testing.assert_allclose(z_l[:n].numpy(), np.asarray(z)[:n],
                               rtol=3e-2, atol=1e-2)


def test_reused_layout_predictions_equal_a_fresh_layout(jax_run):
    """A missing-feature re-evaluation reuses the training graph's layout
    and row plans with the perturbed feature table swapped in: its
    probabilities equal those over a layout built afresh for the perturbed
    graph, bit for bit (layout route, bf16 messages), and no layout is
    built for it; an edge-dropped graph still builds its own."""
    cfg, ds_p = jax_run["cfg"], jax_run["ds_p"]
    pc = _port_cfg(cfg)
    best = pr.train_node_with_buckets(
        ds_p, pc, jax_run["split"], {}, seed=SEED, device="cpu",
        use_layout=True, model=task_model_from_jax(*jax_run["init"], pc))
    masks = {k: jr._pad_mask(v, ds_p.num_nodes, ds_p.num_nodes)
             for k, v in jax_run["split"].items()}
    ds_mf = _perturbed("missing_features", ds_p, masks, pp)
    assert best["graph"].layout is not None
    reused = pr.predict_snapshot_on(ds_mf, pc, best, use_layout=True)
    assert len(best["stats"]["layout_s"]) == 1
    assert len(best["stats"]["feat_swap_s"]) == 1
    fresh = pr.predict_snapshot_on(ds_mf, pc, dict(best, graph=None),
                                   use_layout=True)
    assert len(best["stats"]["layout_s"]) == 2
    assert np.array_equal(reused, fresh)
    # another route than the training graph's, or other edges: a new build
    pr.predict_snapshot_on(ds_mf, pc, best, use_layout=False)
    pr.predict_snapshot_on(_perturbed("edge_drops", ds_p, masks, pp), pc,
                           best, use_layout=True)
    assert len(best["stats"]["layout_s"]) == 4
    assert len(best["stats"]["feat_swap_s"]) == 1


def test_nanmean_std_and_pad_mask_equal_jax():
    for vals in ([1.0, 2.0, np.nan], [np.nan, np.nan], [3.0]):
        got, want = pr.nanmean_std(vals), jr.nanmean_std(vals)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    m = np.array([True, False, True])
    for a in (m, np.array([0, 4])):
        _assert_same_arrays(pr._pad_mask(a, 3, 6), jr._pad_mask(a, 3, 6))


# ---------------------------------------------------------- the scripts

SMALL = ["--feat_dim", "16", "--hidden_dim", "16", "--code_dim", "16",
         "--codebook_size", "8", "--codebook_head", "2", "--epochs", "2",
         "--runs", "1", "--debug"]


def _jax_script(name):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(obj):
    """The JSON's key structure, in order."""
    if isinstance(obj, dict):
        return [(k, _keys(v)) for k, v in obj.items()]
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return None


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_json_matches_the_jax_script(name, tmp_path, monkeypatch):
    """``python -m stemgnn_tpu_torch.scripts.<name> --device cpu`` on
    ``cora_synthetic`` at small dims (no checkpoint: the k-means init) and
    the JAX script on the same flags: the same JSON keys at every level,
    finite accuracies in [0, 100]; ``missing_feature`` also writes its TSV,
    with the JAX script's columns."""
    extra = []
    if name == "missing_feature":
        extra = ["--save_tsv", "1", "--tsv_name"]
    port_json, jax_json = tmp_path / "port.json", tmp_path / "jax.json"
    argv = SMALL + (extra + [str(tmp_path / "port.tsv")] if extra else [])
    proc = subprocess.run(
        [sys.executable, "-m", f"stemgnn_tpu_torch.scripts.{name}",
         "--device", "cpu", "--output_json", str(port_json), *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    monkeypatch.setattr(sys, "argv", [name, "--output_json", str(jax_json),
                                      *SMALL, *(extra + [str(
                                          tmp_path / "jax.tsv")]
                                          if extra else [])])
    _jax_script(name).main()
    got, want = json.loads(port_json.read_text()), json.loads(
        jax_json.read_text())
    assert _keys(got) == _keys(want)
    accs = [v for row in got["runs"] for k, v in row.items()
            if k != "best_epoch"]
    assert accs and all(0.0 <= v <= 100.0 for v in accs), accs
    if name == "missing_feature":
        port_tsv = (tmp_path / "port.tsv").read_text().splitlines()
        jax_tsv = (tmp_path / "jax.tsv").read_text().splitlines()
        assert port_tsv[0] == jax_tsv[0] == "split\tmissing_val\tmissing_test"
        assert len(port_tsv) == len(jax_tsv) == 2
        assert float(port_tsv[1].split("\t")[2]) == \
            got["runs"][0]["perturbed/test"]


@pytest.mark.parametrize("flags,needle", [
    (["--finetune_dataset", "kg_synthetic"],
     "not a node-classification dataset"),
    pytest.param(["--finetune_dataset", "cora"], "Dataset 'cora'",
                 id="flags1-Queue 1 item 8"),
    pytest.param(["--finetune_dataset", "pubmed", "--text_encoder", "e5"],
                 "Dataset 'pubmed'", id="flags2-Queue 1 item 11"),
    (["--finetune_dataset", "FB15K237"],
     "not a node-classification dataset"),
])
@pytest.mark.parametrize("name", ["random_edge_drop", "tri_objective"])
def test_scripts_refuse_what_the_port_does_not_cover(name, flags, needle,
                                                     tmp_path, monkeypatch):
    """Link datasets are refused as in the JAX scripts.  cora and pubmed,
    once refused naming ROADMAP Queue 1 items 8 and 11, now load as in JAX:
    without a cache or raw files the registry raises ``FileNotFoundError``
    (the cache root here a temporary directory)."""
    from stemgnn_tpu_torch.data import importers
    monkeypatch.setattr(importers, "DEFAULT_CACHE_ROOT", str(tmp_path))
    mod = importlib.import_module(f"stemgnn_tpu_torch.scripts.{name}")
    refused = needle.startswith("not a")
    with pytest.raises(SystemExit if refused else FileNotFoundError) as info:
        mod.main(["--device", "cpu", *SMALL, *flags])
    assert needle in str(info.value)
    assert (name in str(info.value)) == refused
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags", [
    ["--backbone", "gat"], ["--moe", "--lamda_env", "0.1"],
    ["--backbone", "gin"]], ids=["gat", "moe", "gin"])
@pytest.mark.parametrize("name", ["random_edge_drop", "tri_objective",
                                  "degree_shift_ood"])
def test_scripts_run_the_other_backbones_and_moe(name, flags):
    """``--backbone gat|gin`` and ``--moe`` with ``--lamda_env``, once
    refused naming ROADMAP Queue 1 item 5, run now: the encoder the flags
    ask for (an MoE last layer with its router; gat / gin layers) and
    finite accuracies in [0, 100] in the JSON's run row."""
    mod = importlib.import_module(f"stemgnn_tpu_torch.scripts.{name}")
    argv = ["--device", "cpu", "--finetune_dataset", "cora_synthetic",
            *SMALL, *flags]
    if "--moe" in flags:
        argv += ["--moe_layers", "last"]
    res = mod.main(argv)
    cfg = res["cfg"]
    assert cfg.encoder.backbone == (flags[1] if "--backbone" in flags
                                    else "sage")
    assert cfg.lamda_env == (0.1 if "--moe" in flags else 0.0)
    assert any(k.startswith("encoder.env_encoders.")
               for k in res["best"]["state"]) == ("--moe" in flags)
    row = res["payload"]["runs"][0]
    accs = [v for k, v in row.items() if k != "best_epoch"]
    assert accs and all(np.isfinite(v) and 0 <= v <= 100 for v in accs)


@pytest.mark.parametrize("flags", [["--use_vq", "0"], ["--freeze_vq", "0"]])
@pytest.mark.parametrize("name", ["random_edge_drop", "tri_objective"])
def test_scripts_run_without_the_vq_or_with_a_trained_codebook(name, flags):
    """``--use_vq 0`` (the decoder reads ``project_in(z)``) and
    ``--freeze_vq 0`` (the codebook in the optimizer), refused before, run
    now: finite accuracies in [0, 100] in the JSON's run row."""
    mod = importlib.import_module(f"stemgnn_tpu_torch.scripts.{name}")
    res = mod.main(["--device", "cpu", "--finetune_dataset", "cora_synthetic",
                    *SMALL, *flags])
    row = res["payload"]["runs"][0]
    accs = [v for k, v in row.items() if k != "best_epoch"]
    assert accs and all(np.isfinite(v) and 0 <= v <= 100 for v in accs)


def test_scripts_without_cuda_exit_nonzero(monkeypatch):
    """No slide to the CPU: without ``--device cpu`` a script asks for CUDA
    and exits when it is absent, in-process and under ``python -m``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module("stemgnn_tpu_torch.scripts."
                                  "degree_shift_ood")
    with pytest.raises(SystemExit) as info:
        mod.main(SMALL)
    assert "CUDA is not available" in str(info.value)
    proc = subprocess.run(
        [sys.executable, "-c", "import torch, runpy, sys; "
         "torch.cuda.is_available = lambda: False; "
         "sys.argv = ['missing_feature', *sys.argv[1:]]; "
         "runpy.run_module('stemgnn_tpu_torch.scripts.missing_feature', "
         "run_name='__main__')", *SMALL],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "--device cpu" in proc.stderr


def test_wandb_sweep_round_trip(monkeypatch):
    """The port's copy of the sweep round-trip: a sweep agent's overrides
    come back into the arguments, coerced to their types; ``debug`` and a
    missing SDK leave them as they are."""
    import argparse
    import types
    ns = argparse.Namespace(lr=0.1, epochs=5, name="x", debug=False)
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert apply_wandb_sweep_config(ns, "proj") is ns and ns.lr == 0.1
    fake = types.SimpleNamespace(run=None, config={})
    seen = {}

    def init(project=None, config=None, **kw):
        seen["project"] = project
        fake.run = object()
        fake.config = dict(config, lr=0.5, epochs="9")
    fake.init = init
    monkeypatch.setitem(sys.modules, "wandb", fake)
    assert apply_wandb_sweep_config(ns, "proj", debug=True).lr == 0.1
    out = apply_wandb_sweep_config(ns, "proj")
    assert seen["project"] == "proj"
    assert out.lr == 0.5 and out.epochs == 9 and out.name == "x"


def test_build_cfg_matches_the_jax_scripts():
    """The scripts' configuration from the same flags equals the JAX
    scripts' field for field (JAX-only fields aside)."""
    _jax_script("degree_shift_ood")         # imports the JAX scripts' _common
    common = sys.modules["_common"]
    for extra in ([], ["--pretrain_path", "p", "--normalize", "batch",
                       "--lr", "0.01", "--epochs", "7"]):
        args_p = port_common.base_parser("x").parse_args(SMALL + extra)
        args_j = common.base_parser("x").parse_args(SMALL + extra)
        got, want = (port_common.build_cfg(args_p, 7),
                     common.build_cfg(args_j, 7))
        for sub in ("encoder", "vq"):
            g, w = vars(getattr(got, sub)), vars(getattr(want, sub))
            assert {k: g[k] for k in w if k in g} == \
                {k: v for k, v in w.items() if k in g}
        g, w = vars(got), vars(want)
        for k in w:
            if k in g and k not in ("encoder", "vq"):
                assert g[k] == w[k], k
