"""The port's halo full-graph finetune (``stemgnn_tpu_torch/parallel/
full_graph.py`` and ``finetune --halo_shards``) against the JAX package on
the CPU.

  * One ``make_halo_steps`` train step on 2 gloo ranks (the fused route,
    kernel 2's plain version over every rank's local and remote layouts),
    SGD at lr 1 from JAX's initial task model with an unfrozen EMA
    codebook: the loss, every parameter and the VQ's state against JAX's
    S = 2 step under ``shard_map`` (Pallas in interpret mode) and against
    the port's single-device step, to 2e-4 as
    ``test_halo_train_grads_match_single_device`` holds JAX's; then the
    metrics step against JAX's.
  * ``python -m stemgnn_tpu_torch.finetune --halo_shards 2 --device cpu``,
    2 epochs from a checkpoint, against JAX's ``run_finetune_halo_parallel``
    on 2 fake devices started from the port's initial task model, with
    ``--halo_order none``, ``balance`` and ``community`` (the last with the
    unfrozen VQ): each epoch's loss to 1e-5, accuracies within one item.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import halo_workers
from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.data import registry as jax_registry
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.models import task as jax_task
from stemgnn_tpu.parallel import full_graph as jfg
from stemgnn_tpu.parallel.mesh import make_mesh
from stemgnn_tpu.train.finetune_loop import _split_params as jax_split
from stemgnn_tpu_torch import finetune as port_finetune
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.models.task import task_model_init
from stemgnn_tpu_torch.parallel import mesh
from stemgnn_tpu_torch.train import finetune_loop as port_ft
from stemgnn_tpu_torch.train.graph_setup import fused_full_graph
from stemgnn_tpu_torch.utils import checkpoint as port_ckpt
from stemgnn_tpu_torch.utils.convert import (from_jax_pytree,
                                             task_model_from_jax,
                                             task_model_to_jax)

S, D = 2, 16
STEP_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _port_cfg(cfg):
    return pcfg.from_dict(pcfg.FinetuneConfig(), dataclasses.asdict(cfg))


def _mesh():
    return make_mesh(axis_names=("edge",),
                     devices=np.asarray(jax.devices()[:S]))


# ------------------------------------------------------- one train step

@pytest.fixture(scope="module")
def step():
    kw = dict(num_nodes=260, num_classes=4, feat_dim=D, num_splits=1,
              train_per_split=60, val_per_split=60, seed=3)
    ds_j = jax_synthetic.synthetic_node_dataset(**kw)
    ds_p = port_synthetic.synthetic_node_dataset(**kw)
    cfg = jcfg.FinetuneConfig(
        # f32 messages: the single-device step takes the plain route
        encoder=jcfg.EncoderConfig(input_dim=D, hidden_dim=D, num_layers=2,
                                   normalize="batch", dropout=0.0,
                                   fused_bf16_messages=False),
        vq=jcfg.VQConfig(dim=D, codebook_size=8, codebook_dim=8, heads=2,
                         commitment_weight=0.25, ema_update=True),
        task="node", epochs=1, lr=1.0, repeat=1, num_classes=4,
        freeze_vq=False)
    params, state = jax_task.task_model_init(jax.random.PRNGKey(4), cfg)
    init = (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    pc = _port_cfg(cfg)
    outs = mesh.spawn(halo_workers.train_checks, S, "cpu",
                      dict(cfg=pc, ds=ds_p, init=init))
    st = dict(ds_j=ds_j, ds_p=ds_p, cfg=cfg, pc=pc, init=init, outs=outs)
    st["jax"] = _jax_step(st)
    return st


def _jax_step(st):
    """JAX's S = 2 fused step (SGD at lr 1) and its metrics after it."""
    cfg, ds = st["cfg"], st["ds_j"]
    tx = optax.sgd(1.0)
    sg, nb, _, layouts, edge_table = jfg.prepare_halo_graph(
        ds, S, fused=True, hub_size=0, edge_chunk=128)
    n = ds.num_nodes
    y = np.zeros(S * nb, np.int32)
    y[:n] = np.asarray(ds.labels)
    masks = {}
    for k in ("train", "valid", "test"):
        m = np.zeros(S * nb, bool)
        m[:n] = np.asarray(ds.splits[0][k])
        masks[k] = m.reshape(S, nb)
    y = jnp.asarray(y.reshape(S, nb))
    train, _, metrics = jfg.make_halo_steps(
        cfg, tx, _mesh(), y, layouts=layouts, edge_table=edge_table,
        interpret=True)
    trainable, frozen = jax_split(st["init"][0], cfg)
    tr, _, new_state, loss = train(
        trainable, frozen, tx.init(trainable), st["init"][1],
        jax.random.PRNGKey(5), jnp.asarray(masks["train"]), y, sg, *layouts)
    accs = metrics(tr, frozen, new_state, y, jnp.asarray(np.stack(
        [masks[k] for k in ("train", "valid", "test")])), sg, *layouts)
    return dict(tr, **frozen), new_state, float(loss), np.asarray(accs)


def _port_single_step(st):
    """The port's single-device step (SGD at lr 1) on the same model."""
    pc, ds = st["pc"], st["ds_p"]
    model = task_model_from_jax(*st["init"], pc)
    graph = fused_full_graph(ds, pc, device="cpu")
    y = np.zeros(graph.num_nodes_padded, np.int64)
    y[:ds.num_nodes] = np.asarray(ds.labels)
    tm = np.zeros(graph.num_nodes_padded, bool)
    tm[:ds.num_nodes] = np.asarray(ds.splits[0]["train"])
    trainable, _ = port_ft._split_params(model, pc)
    opt = torch.optim.SGD(list(trainable.values()), lr=1.0)
    _, train_step, _ = port_ft._make_node_steps(pc)
    parts = train_step(model, opt, torch.from_numpy(tm), graph,
                       torch.from_numpy(y))
    return model, float(parts["loss"])


def test_train_step_matches_jax_and_the_single_device_step(step):
    want_p, want_s, want_loss, _ = step["jax"]
    single, single_loss = _port_single_step(step)
    sp, ss = task_model_to_jax(single)
    for o in step["outs"]:
        np.testing.assert_allclose(o["loss"], want_loss, **LOSS_TOL)
        np.testing.assert_allclose(o["loss"], single_loss, **LOSS_TOL)
        got_p = _leaves(o["params"])
        for ref in (_leaves(want_p), _leaves(sp)):
            assert set(got_p) == set(ref)
            for k in ref:
                np.testing.assert_allclose(got_p[k], ref[k], **STEP_TOL,
                                           err_msg=k)
        got_s = _leaves(o["state"])
        for ref in (_leaves(want_s), _leaves(ss)):
            for k in ("['vq']['cluster_size']", "['vq']['embed_avg']",
                      "['encoder']['norms'][0]['mean']",
                      "['encoder']['norms'][1]['var']"):
                np.testing.assert_allclose(got_s[k], ref[k], **STEP_TOL,
                                           err_msg=k)
    # the step moved the codebook: the EMA sums saw both ranks' rows
    before = _leaves(step["init"][1])["['vq']['cluster_size']"]
    assert not np.allclose(got_s["['vq']['cluster_size']"], before)


def test_metrics_step_matches_jax(step):
    *_, want = step["jax"]
    for o in step["outs"]:
        np.testing.assert_allclose(o["accs"], want, rtol=1e-6)


# ------------------------------------------------------- the CLI runs

def _write_checkpoint(path, cfg):
    """A pretrained encoder and an initted VQ in the JAX package's
    format; returns JAX's ``pretrained`` bundle of them."""
    from stemgnn_tpu.nn.encoder import encoder_init
    from stemgnn_tpu.vq import vq_init
    ke, kv = jax.random.split(jax.random.PRNGKey(7))
    ep, es = encoder_init(ke, cfg.encoder)
    vp, vs = vq_init(kv, cfg.vq)
    vs = dict(vs, initted=True)
    tree = jax.tree.map(np.asarray, {"ep": ep, "es": es, "vp": vp, "vs": vs})
    port_ckpt.save_pytree(str(path / "encoder_1.npz"),
                          {"params": tree["ep"], "state": tree["es"]})
    port_ckpt.save_pytree(str(path / "vq_1.npz"),
                          {"params": tree["vp"], "state": tree["vs"]})
    return {"encoder_params": tree["ep"], "encoder_state": tree["es"],
            "vq_params": tree["vp"], "vq_state": tree["vs"]}


@pytest.mark.parametrize("order,freeze", [("none", 1), ("balance", 1),
                                          ("community", 0)])
def test_cli_matches_jax_halo_runner(order, freeze, tmp_path, monkeypatch):
    argv = ["--finetune_dataset", "cora_synthetic", "--feat_dim", str(D),
            "--hidden_dim", str(D), "--code_dim", "8", "--codebook_size",
            "8", "--codebook_head", "2", "--epochs", "2", "--repeat", "1",
            "--dropout", "0", "--lr", "1e-2", "--freeze_vq", str(freeze),
            "--pretrain_path", str(tmp_path), "--pretrain_model_epoch", "1",
            "--halo_shards", str(S), "--halo_order", order, "--device",
            "cpu", "--debug"]
    args = port_finetune.parse(argv)
    ds_j = jax_registry.load_dataset("cora_synthetic", feat_dim=D,
                                     seed=args.seed)
    pc = port_finetune.make_config(args, ds_j.num_classes)
    cfg = jcfg.from_dict(jcfg.FinetuneConfig(), dataclasses.asdict(pc))
    bundle = _write_checkpoint(tmp_path, cfg)
    # JAX starts from the port's initial task model of split 0
    enc, vq = from_jax_pytree(
        {"encoder": bundle["encoder_params"], "vq": bundle["vq_params"]},
        {"encoder": bundle["encoder_state"], "vq": bundle["vq_state"]}, pc)
    init = task_model_to_jax(task_model_init(
        pc, enc, vq, generator=torch.Generator().manual_seed(0)))
    monkeypatch.setattr(jfg.task_model, "task_model_init",
                        lambda *a, **k: jax.tree.map(jnp.asarray, init))
    logged = []

    class Recorder(jfg.Logger):
        def log(self, run, epoch, loss, result):
            logged.append((dict(loss), dict(result)))
            return super().log(run, epoch, loss, result)
    monkeypatch.setattr(jfg, "Logger", Recorder)
    jfg.run_finetune_halo_parallel(ds_j, cfg, _mesh(), pretrained=bundle,
                                   order=order)
    res = port_finetune.main(argv)
    ranks = res["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    n = {k: int(np.asarray(ds_j.splits[0][k]).sum())
         for k in ("train", "valid", "test")}
    for rec in ranks:
        hist = rec["history"]
        assert rec["backend"] == "gloo" and not rec["fused"]
        assert len(hist) == len(logged) == 2
        for h, (want_loss, want_acc) in zip(hist, logged):
            np.testing.assert_allclose(h["losses"]["loss"],
                                       want_loss["loss"], **LOSS_TOL)
            for got, k, split in zip(h["accs"], ("train", "val", "test"),
                                     ("train", "valid", "test")):
                assert abs(got - want_acc[k]) <= 100.0 / n[split] + 1e-9
