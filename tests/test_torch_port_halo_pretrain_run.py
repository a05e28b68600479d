"""The port's halo pretrain runner (``run_pretrain_halo``, ``pretrain
--halo_shards``) against the JAX package on the CPU, on 2-rank gloo worlds
whose ranks run ``tests/halo_workers.py`` (JAX on two of the fake CPU
devices of ``tests/conftest.py``, its kernels in interpret mode):

  * two epochs of ``run_pretrain_halo`` with JAX's draws against JAX's
    ``run_pretrain_halo``, f32 and under mixed precision (the bf16
    encoder, VQ pipeline, teacher and loss decoders);
  * the k-means seeding (rank 0, broadcast), the parameters bit-equal
    across ranks after each epoch, every layout's keeps on the CPU, and
    the checkpoint read by ``finetune`` plain and ``--halo_shards 2``.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import halo_workers
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.data.merge import merge_datasets as jax_merge
from stemgnn_tpu.models import pretrain as jax_pre
from stemgnn_tpu.parallel import halo_pretrain as jhp
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.data.merge import merge_datasets as port_merge
from stemgnn_tpu_torch.parallel import mesh
from test_torch_port_halo_pretrain import (D, _jax_cfg, _jax_draws,
                                           _jax_mesh, _np, _port_cfg)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, EPOCHS = 2, 2


def _merged(pkg):
    ds = pkg.synthetic_node_dataset(num_nodes=150, num_classes=4,
                                    feat_dim=D, train_per_split=20,
                                    val_per_split=20, num_splits=1, seed=0)
    return ds, (jax_merge if pkg is jax_synthetic else port_merge)([ds])


def _run_draws(cfg, merged, S, epochs, key):
    """JAX ``run_pretrain_halo``'s draws for ``epochs`` epochs from its key
    after the init split (:428-429, 468-469)."""
    node_feat = np.asarray(merged["node_text_feat"],
                           np.float32)[np.asarray(merged["x"])]
    sg, nb, _, _ = jhp.prepare_halo_pretrain_graph(
        node_feat, np.asarray(merged["edge_index"]), S,
        xe_ids=np.asarray(merged["xe"], np.int32),
        edge_table=merged["edge_text_feat"])
    out = []
    for _ in range(epochs):
        key, k = jax.random.split(key)
        rngs = jax.random.split(k, 1)
        out.append([[_jax_draws(cfg, sg, nb, rngs[0], e)
                     for e in range(S)]])
    return out


@pytest.fixture(scope="module")
def jax_f32():
    """JAX's f32 run: its history."""
    _, merged_j = _merged(jax_synthetic)
    return jhp.run_pretrain_halo(
        merged_j, _jax_cfg(epochs=EPOCHS, seed=0), _jax_mesh(1, S),
        weights=[1.0], verbose=False, interpret=True)[3]


@pytest.mark.parametrize("mp", [False, True], ids=["f32", "mixed"])
def test_run_pretrain_halo_matches_jax(mp, jax_f32):
    """Two epochs of ``run_pretrain_halo`` (S = 2) from JAX's initial
    weights with JAX's draws, against JAX's runner: each epoch's losses
    within 1e-3 relative in f32; under mixed precision (bf16 encoder and
    VQ pipeline, the bf16 teacher and loss decoders) within 2e-2, the
    bf16 roundings of one pass taken in another order, and within 5% of
    the f32 run's, as JAX's own mixed-precision test holds it."""
    epochs = EPOCHS
    cfg = _jax_cfg(epochs=epochs, seed=0)
    if mp:
        cfg = dataclasses.replace(
            cfg, encoder=dataclasses.replace(cfg.encoder,
                                             compute_dtype="bfloat16"),
            vq=dataclasses.replace(cfg.vq, compute_dtype="bfloat16"),
            teacher_bf16=True, loss_bf16=True)
    _, merged_j = _merged(jax_synthetic)
    _, merged_p = _merged(port_synthetic)
    hist_j = jax_f32 if not mp else jhp.run_pretrain_halo(
        merged_j, cfg, _jax_mesh(1, S), weights=[1.0], verbose=False,
        interpret=True)[3]
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init = jax.random.split(key)
    init = _np(jax_pre.pretrain_init(k_init, cfg))
    inp = dict(merged=merged_p, cfg=_port_cfg(cfg), S=S, init=init,
               draws=_run_draws(cfg, merged_j, S, epochs, key),
               kw=dict(weights=[1.0], verbose=False))
    outs = mesh.spawn(halo_workers.halo_pretrain_run, S, "cpu", inp)
    tol = 2e-2 if mp else 1e-3
    for e, hj in enumerate(hist_j):
        got = outs[0]["history"][e]["losses"]
        for k, v in hj.items():
            if k == "epoch_s":
                continue
            assert abs(got[k] - v) <= tol * abs(v) + 1e-6, (e, k, got[k], v)
    assert outs[0]["digests"] == [] and outs[0]["rank"] == 0
    if mp:
        rel = abs(outs[0]["history"][0]["losses"]["loss"]
                  - jax_f32[0]["loss"]) / abs(jax_f32[0]["loss"])
        assert rel < 0.05, rel


def test_kmeans_seeding_and_checkpoint_handoff(tmp_path):
    """``pretrain --halo_shards 2 --device cpu`` with a k-means codebook:
    every rank's codebook seeded (rank 0 encodes, the others receive it)
    and the parameters bit-equal across ranks after each epoch, with the
    keeps of every layout equal to the CPU's; its checkpoint read by
    ``finetune`` plain and ``--halo_shards 2``."""
    _, merged = _merged(port_synthetic)
    cfg = dataclasses.replace(_port_cfg(_jax_cfg(epochs=2, seed=0)),
                              vq=dataclasses.replace(
                                  _port_cfg(_jax_cfg()).vq,
                                  kmeans_init=True))
    outs = mesh.spawn(halo_workers.halo_pretrain_run, 2, "cpu", dict(
        merged=merged, cfg=cfg, S=2,
        kw=dict(weights=[1.0], verbose=False, hub_size=8, record=True,
                save_root=str(tmp_path))))
    assert outs[0]["digests"] == outs[1]["digests"]
    assert len(outs[0]["digests"]) == 2
    vq = outs[0]["trees"][2]["vq"]
    assert bool(np.asarray(vq["initted"]))
    assert float(np.asarray(vq["cluster_size"]).sum()) > 0
    for o in outs:
        for rep in o["keeps"].values():
            assert rep["edges"] > 0 and rep["differ"] == 0
            assert rep["hub_differ"] == 0
    assert sorted(os.listdir(tmp_path)) == [
        f"{p}_{e}.npz" for p in ("encoder", "full", "vq") for e in (1, 2)]
    base = [sys.executable, "-m", "stemgnn_tpu_torch.finetune",
            "--finetune_dataset", "cora_synthetic", "--feat_dim", str(D),
            "--hidden_dim", str(D), "--code_dim", "8", "--codebook_size",
            "16", "--codebook_head", "2", "--pretrain_path", str(tmp_path),
            "--pretrain_model_epoch", "2", "--epochs", "2", "--repeat", "1",
            "--debug", "--device", "cpu"]
    for extra in ([], ["--halo_shards", "2"]):
        proc = subprocess.run(base + extra, cwd=ROOT, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "final/test" in proc.stdout, proc.stdout[-2000:]
