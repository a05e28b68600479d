"""The port's serving slice against the JAX package on the CPU: datasets,
checkpoints, weights carried across, the whole encode (encoder + VQ) and the
``infer --mode encode`` CLI."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from stemgnn_tpu.core.config import EncoderConfig as JEncoderConfig
from stemgnn_tpu.core.config import VQConfig as JVQConfig
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.nn.encoder import encoder_apply, encoder_init
from stemgnn_tpu.utils import checkpoint as jax_ckpt
from stemgnn_tpu.vq.quantize import vq_apply, vq_init
from stemgnn_tpu_torch.core.config import (EncoderConfig, FinetuneConfig,
                                           VQConfig)
from stemgnn_tpu_torch.data import registry
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.train.graph_setup import fused_full_graph
from stemgnn_tpu_torch.utils import checkpoint as port_ckpt
from stemgnn_tpu_torch.utils.convert import from_jax_pytree, to_jax_pytree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32


def _dataset(pkg, seed=3):
    return pkg.synthetic_node_dataset(num_nodes=400, num_classes=5,
                                      feat_dim=D, avg_degree=8,
                                      pref_attach=1.1, num_splits=1,
                                      seed=seed)


def _jax_models(d=D, seed=0, heads=4, codes=16):
    """JAX encoder + VQ at width ``d`` with non-trivial BatchNorm statistics,
    as nested numpy trees."""
    ecfg = dict(input_dim=d, hidden_dim=d, num_layers=2, normalize="batch",
                dropout=0.0)
    vcfg = dict(dim=d, codebook_size=codes, codebook_dim=d, heads=heads)
    ep, es = encoder_init(jax.random.PRNGKey(seed), JEncoderConfig(**ecfg))
    vp, vs = vq_init(jax.random.PRNGKey(seed + 1), JVQConfig(**vcfg))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    params = {"encoder": to_np(ep), "vq": to_np(vp)}
    state = {"encoder": to_np(es), "vq": to_np(vs)}
    rng = np.random.default_rng(seed)
    for bn in state["encoder"]["norms"]:
        bn["mean"] = rng.normal(0, 0.1, d).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
    return params, state, ecfg, vcfg


def test_synthetic_datasets_equal_jax():
    for kw in (dict(num_nodes=300, feat_dim=16, seed=1),
               dict(num_nodes=500, feat_dim=8, avg_degree=14, num_splits=1,
                    pref_attach=1.1, num_classes=40, seed=42)):
        a = jax_synthetic.synthetic_node_dataset(**kw)
        b = port_synthetic.synthetic_node_dataset(**kw)
        for f in ("node_text_feat", "edge_text_feat", "x", "xe",
                  "edge_index", "labels"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        for sa, sb in zip(a.splits, b.splits):
            assert all(np.array_equal(sa[k], sb[k]) for k in sa)


def test_registry_loads_synthetic_and_refuses_the_rest():
    ds = registry.load_dataset("arxiv_synthetic_pl", feat_dim=8, seed=0,
                               num_nodes=1000)
    assert ds.num_nodes == 1000 and ds.node_text_feat.shape == (1000, 8)
    with pytest.raises(NotImplementedError):
        registry.load_dataset("WN18RR")
    with pytest.raises(KeyError):
        registry.load_dataset("no_such_dataset")


def test_checkpoints_load_across_packages(tmp_path):
    params, state, _, _ = _jax_models()
    tree = {"params": params["encoder"], "state": state["encoder"]}
    jax_ckpt.save_pytree(str(tmp_path / "j.npz"), tree, meta={"epoch": 3})
    port_ckpt.save_pytree(str(tmp_path / "p.npz"), tree)
    assert port_ckpt.load_meta(str(tmp_path / "j.npz")) == {"epoch": 3}
    assert port_ckpt.load_meta(str(tmp_path / "p.npz")) is None
    for got in (port_ckpt.load_pytree(str(tmp_path / "j.npz")),
                jax_ckpt.load_pytree(str(tmp_path / "p.npz"))):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(jax_ckpt.load_pytree(
                str(tmp_path / "j.npz")))
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(tree)):
            assert np.array_equal(a, b)


def test_weights_round_trip_through_the_converter():
    params, state, ecfg, vcfg = _jax_models()
    cfg = FinetuneConfig(encoder=EncoderConfig(**ecfg), vq=VQConfig(**vcfg))
    enc, vq = from_jax_pytree(params, state, cfg)
    p2, s2 = to_jax_pytree(enc, vq)
    for a, b in ((params, p2), (state, s2)):
        fa = jax.tree_util.tree_leaves_with_path(a)
        fb = dict(jax.tree_util.tree_leaves_with_path(b))
        assert len(fa) == len(fb)
        for path, leaf in fa:
            assert np.array_equal(leaf, fb[path]), path


def _encode_both(bf16_messages):
    params, state, ecfg, vcfg = _jax_models()
    ds_j, ds_p = _dataset(jax_synthetic), _dataset(port_synthetic)
    # JAX on CPU: the plain padded graph with materialized edge features
    g = ds_j.to_graph()
    z_j, _, _ = encoder_apply(
        params["encoder"], state["encoder"], JEncoderConfig(**ecfg),
        g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
        edge_mask=g.edge_mask, node_mask=g.node_mask, training=False)
    res_j = vq_apply(params["vq"], state["vq"], JVQConfig(**vcfg), z_j,
                     training=False)
    # port: the layout path (hub split + scatter kernel's plain version)
    cfg = FinetuneConfig(
        encoder=EncoderConfig(**ecfg, fused_bf16_messages=bf16_messages),
        vq=VQConfig(**vcfg), hub_size=128, sc_hub_size=128)
    enc, vq = from_jax_pytree(params, state, cfg)
    gp = fused_full_graph(ds_p, cfg, device="cpu", use_layout=True)
    assert gp.layout.hub_r is not None and gp.layout.hub_r.sc_cnt is not None
    with torch.no_grad():
        z_p = enc(gp.node_feat, gp.senders, gp.receivers,
                  layout=gp.layout, edge_table=gp.edge_table)
        res_p = vq(z_p)
        res_pj = vq(torch.from_numpy(np.array(z_j)))   # same z as JAX's
    n = ds_j.num_nodes
    return (np.asarray(z_j)[:n], res_j, z_p[:n].numpy(),
            {k: v[:n].numpy() for k, v in res_p.items()
             if k not in ("distances", "loss")},
            res_pj, n)


def _top2_gap(dist):
    """[num_codebooks, N, C] -> [N, H] gap between the two best scores."""
    top = np.sort(np.asarray(dist), axis=-1)
    return (top[..., -1] - top[..., -2]).T


def test_encode_f32_messages_matches_jax():
    z_j, res_j, z_p, res_p, res_pj, n = _encode_both(bf16_messages=False)
    np.testing.assert_allclose(z_p, z_j, rtol=1e-4, atol=1e-4)
    # the VQ on the same z: codes equal wherever the best two differ
    codes_j = np.asarray(res_j["indices"])[:n]
    decided = _top2_gap(res_j["distances"])[:n] > 1e-4
    assert decided.mean() > 0.9
    assert np.array_equal(res_pj["indices"].numpy()[:n][decided],
                          codes_j[decided])
    np.testing.assert_allclose(res_pj["distances"].numpy(),
                               np.asarray(res_j["distances"]), rtol=1e-4,
                               atol=1e-5)
    # the chained encode: codes where decided, quantize on agreeing rows
    assert np.array_equal(res_p["indices"][decided], codes_j[decided])
    rows = (res_p["indices"] == codes_j).all(1)
    np.testing.assert_allclose(res_p["quantize"][rows],
                               np.asarray(res_j["quantize"])[:n][rows],
                               rtol=1e-4, atol=1e-4)


def test_encode_bf16_messages_matches_jax():
    z_j, res_j, z_p, res_p, _, n = _encode_both(bf16_messages=True)
    # one bf16 rounding of x per layer in the messages
    np.testing.assert_allclose(z_p, z_j, rtol=3e-2, atol=3e-2)
    same = (res_p["indices"] == np.asarray(res_j["indices"])[:n]).all(1)
    assert same.mean() >= 0.99


def _load_jax_infer():
    spec = importlib.util.spec_from_file_location(
        "repo_infer", os.path.join(ROOT, "infer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_encode_matches_jax_infer_outputs(tmp_path, monkeypatch):
    """``python -m stemgnn_tpu_torch.infer --device cpu`` on cora_synthetic
    with a checkpoint written by the JAX package's ``save_pytree`` gives the
    npz keys and shapes of ``infer.py``."""
    d = 16
    params, state, _, _ = _jax_models(d=d, codes=128)
    for part in ("encoder", "vq"):
        jax_ckpt.save_pytree(str(tmp_path / f"{part}_50.npz"),
                             {"params": params[part], "state": state[part]})
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"encoder": {"num_layers": 2}, "vq": {"heads": 4}}, f)
    common = ["--finetune_dataset", "cora_synthetic", "--feat_dim", str(d),
              "--pretrain_path", str(tmp_path), "--seed", "42"]
    out_p = str(tmp_path / "port.npz")
    proc = subprocess.run(
        [sys.executable, "-m", "stemgnn_tpu_torch.infer", *common,
         "--device", "cpu", "--out", out_p],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

    out_j = str(tmp_path / "jax.npz")
    jax_infer = _load_jax_infer()
    import stemgnn_tpu.utils.jax_cache as jax_cache
    monkeypatch.setattr(jax_cache, "enable_persistent_cache", lambda: None)
    monkeypatch.setattr(sys, "argv", ["infer.py", *common, "--out", out_j])
    jax_infer.main()

    got, want = np.load(out_p), np.load(out_j)
    assert sorted(got.files) == sorted(want.files) == [
        "codes", "embeddings", "quantized"]
    for k in want.files:
        assert got[k].shape == want[k].shape, k
    assert want["codes"].shape == (2708, 4)
    # on CPU both run the plain gather/scatter path: the values agree too
    np.testing.assert_allclose(got["embeddings"], want["embeddings"],
                               rtol=1e-4, atol=1e-4)
