"""The port's v1 edge-partitioned full-graph finetune
(``stemgnn_tpu_torch/parallel/edge_partition.py`` and the v1 half of
``parallel/full_graph.py``) against the JAX package on the CPU.

  * ``partition_edges_by_destination`` equal to JAX's for S = 1, 2, 3 and
    8 (at 8 the last shards are empty), with per-edge features and type
    ids.
  * ``sharded_sage_aggregate`` on 2- and 3-rank gloo worlds
    (``tests/edge_parallel_workers.py``) against JAX's under ``shard_map``
    on as many of the fake CPU devices of ``tests/conftest.py``, mean and
    sum, with and without edge features: the value, and the gradients in
    ``x`` and in a weight before the aggregation averaged across ranks
    against JAX's ``pmean`` and against one device's gradient (1e-5).
  * ``run_finetune_edge_parallel`` at S = 2 from JAX's initial task model
    against JAX's on a 2-device mesh, with an initted codebook and with
    the k-means init (JAX's initial means handed to rank 0): every
    epoch's loss to 1e-5 relative, every accuracy equal, the ranks'
    parameters bit-equal; then the counterpart of
    ``tests/test_parallel.py::test_edge_parallel_finetune_matches_single``
    (test accuracy above 75 after 50 epochs).
  * The edge-sharded encoder refuses what JAX would aggregate over one
    shard only (gcn / gin / gat, an MoE layer), and a shard refuses a
    layout and the pair-hash dropout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import edge_parallel_workers
from stemgnn_tpu.core import config as jcfg
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.models import task as jax_task
from stemgnn_tpu.ops import spmm as jspmm
from stemgnn_tpu.parallel import edge_partition as jep
from stemgnn_tpu.parallel import full_graph as jfg
from stemgnn_tpu.parallel.mesh import make_mesh
from stemgnn_tpu.vq import codebook as jax_cb
from stemgnn_tpu_torch.core import config as pcfg
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.nn.encoder import Encoder
from stemgnn_tpu_torch.ops.spmm import (gather_scatter_aggregate,
                                        sage_aggregate)
from stemgnn_tpu_torch.parallel import edge_partition as pep
from stemgnn_tpu_torch.parallel import mesh

N, E, D = 50, 600, 8
TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [(reduce, ef) for reduce in ("mean", "sum") for ef in (False, True)]


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N, E).astype(np.int32)
    r = rng.integers(0, N, E).astype(np.int32)
    return dict(s=s, r=r,
                x=rng.standard_normal((N, D)).astype(np.float32),
                w=rng.standard_normal((D, D)).astype(np.float32),
                ef=rng.standard_normal((E, D)).astype(np.float32),
                cot=rng.standard_normal((N, D)).astype(np.float32),
                cases=CASES)


def _mesh(shards):
    return make_mesh(axis_names=("edge",),
                     devices=np.asarray(jax.devices()[:shards]))


# ------------------------------------------------------------------ host

@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_partition_equals_jax(shards):
    """At S = 8 the 200 edges fill shards 0-1 and leave 2-7 empty."""
    rng = np.random.default_rng(shards)
    e = 200 if shards == 8 else E
    s = rng.integers(0, N, e).astype(np.int32)
    r = rng.integers(0, 12, e).astype(np.int32)      # many ties: stability
    for ef in (rng.standard_normal((e, D)).astype(np.float32),
               rng.integers(0, 5, e).astype(np.int32), None):
        want = jep.partition_edges_by_destination(s, r, shards, edge_feat=ef)
        got = pep.partition_edges_by_destination(s, r, shards, edge_feat=ef)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if shards == 8:
        assert got["edge_mask"][:2].any(1).all()
        assert not got["edge_mask"][2:].any()


# ------------------------------------------------------- the aggregation

@pytest.fixture(scope="module")
def worlds():
    """Each world size's rank outputs on one graph (the 2-rank world
    prestarted while the 3-rank one runs)."""
    mesh.prestart(2, "cpu")
    inp = _graph()
    outs = {S: mesh.spawn(edge_parallel_workers.aggregate_checks, S, "cpu",
                          inp) for S in (3, 2)}
    return inp, outs


def _jax_aggregate(inp, shards, reduce, with_ef):
    """JAX's value and ``pmean`` gradients under shard_map."""
    part = jep.partition_edges_by_destination(inp["s"], inp["r"], shards,
                                              edge_feat=inp["ef"])

    def f(x, w, cot, s, r, m, ef):
        def loss(x, w):
            out = jep.sharded_sage_aggregate(
                x @ w, s[0], r[0], m[0], ef[0] if with_ef else None,
                axis="edge", reduce=reduce)
            return jnp.sum(out * cot), out
        (_, out), (gx, gw) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(x, w)
        return out, jax.lax.pmean(gx, "edge"), jax.lax.pmean(gw, "edge")
    fn = jax.jit(jax.shard_map(
        f, mesh=_mesh(shards), in_specs=(P(),) * 3 + (P("edge"),) * 4,
        out_specs=(P(), P(), P()), check_vma=False))
    return [np.asarray(a) for a in fn(
        inp["x"], inp["w"], inp["cot"], part["senders"], part["receivers"],
        part["edge_mask"], part["edge_feat"])]


def _single_device(inp, reduce, with_ef):
    """The port's one-device value and gradients on the whole graph."""
    x = torch.tensor(inp["x"], requires_grad=True)
    w = torch.tensor(inp["w"], requires_grad=True)
    out = gather_scatter_aggregate(
        x @ w, torch.from_numpy(inp["s"]).long(),
        torch.from_numpy(inp["r"]).long(),
        edge_feat=torch.from_numpy(inp["ef"]) if with_ef else None,
        reduce=reduce)
    (out * torch.from_numpy(inp["cot"])).sum().backward()
    return out.detach().numpy(), x.grad.numpy(), w.grad.numpy()


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("reduce,with_ef", CASES)
def test_sharded_aggregate_value_and_gradients(worlds, shards, reduce,
                                               with_ef):
    inp, outs = worlds
    want = _jax_aggregate(inp, shards, reduce, with_ef)
    one = _single_device(inp, reduce, with_ef)
    # JAX's one-device aggregation gives the same value
    np.testing.assert_allclose(np.asarray(jspmm.gather_scatter_aggregate(
        jnp.asarray(inp["x"] @ inp["w"]), inp["s"], inp["r"],
        edge_feat=inp["ef"] if with_ef else None, reduce=reduce)), one[0],
        **TOL)
    for o in outs[shards]:
        got = o[(reduce, with_ef)]
        for key, w_jax, w_one in (("value", want[0], one[0]),
                                  ("gx", want[1], one[1]),
                                  ("gw", want[2], one[2])):
            np.testing.assert_allclose(got[key], w_jax, **TOL, err_msg=key)
            np.testing.assert_allclose(got[key], w_one, **TOL, err_msg=key)
    # before the average a rank's x gradient is S times its shard's share
    # (the aggregation's backward summed the ranks' equal cotangents), not
    # one device's gradient
    own = [o[(reduce, with_ef)]["own_gx"] for o in outs[shards]]
    assert not np.allclose(own[0], one[1], **TOL)
    np.testing.assert_allclose(np.mean(own, 0), one[1], **TOL)


def test_encoder_refuses_what_jax_would_sum_over_one_shard():
    x = torch.zeros(8, D)
    e = torch.zeros(4, dtype=torch.long)
    for kw in (dict(backbone="gcn"), dict(backbone="gin"),
               dict(backbone="gat"),
               dict(moe=True, moe_layers="last", num_experts=2)):
        enc = Encoder(pcfg.EncoderConfig(input_dim=D, hidden_dim=D,
                                         num_layers=2, **kw))
        with pytest.raises(ValueError, match="sage layers only"):
            enc(x, e, e, edge_shard_ranks=object())
    # a shard takes neither a layout nor the pair-hash dropout
    for kw in (dict(layout=object()), dict(drop_hash=(1, 0.2))):
        with pytest.raises(ValueError, match="no layout and no drop_hash"):
            sage_aggregate(x, e, e, shard_ranks=object(), **kw)


# ------------------------------------------------------------ the runner

def _cfgs(kmeans, epochs, **kw):
    cfg = jcfg.FinetuneConfig(
        encoder=jcfg.EncoderConfig(input_dim=16, hidden_dim=16, num_layers=2,
                                   normalize="batch", dropout=0.0),
        vq=jcfg.VQConfig(dim=16, codebook_size=8, codebook_dim=8, heads=2,
                         commitment_weight=0.25, kmeans_init=kmeans),
        task="node", epochs=epochs, lr=1e-2, repeat=1, num_classes=4, **kw)
    return cfg, pcfg.from_dict(pcfg.FinetuneConfig(), dataclasses.asdict(cfg))


def _datasets(**kw):
    kw = dict(num_nodes=300, num_classes=4, feat_dim=16, train_per_split=50,
              val_per_split=60, num_splits=1, seed=1, **kw)
    return (jax_synthetic.synthetic_node_dataset(**kw),
            port_synthetic.synthetic_node_dataset(**kw))


@pytest.mark.parametrize("kmeans", [False, True])
def test_runner_matches_jax(kmeans, monkeypatch):
    cfg, pc = _cfgs(kmeans, epochs=6)
    ds_j, ds_p = _datasets()
    logged, inits, means = [], [], []

    class Recorder(jfg.Logger):
        def log(self, run, epoch, loss, result):
            logged.append((dict(loss), dict(result)))
            return super().log(run, epoch, loss, result)
    real_init, real_sample = (jax_task.task_model_init,
                              jax_cb.batched_sample_vectors)

    def init_rec(*a, **k):
        out = real_init(*a, **k)
        inits.append(jax.tree.map(np.asarray, out))
        return out

    def sample_rec(*a, **k):
        out = real_sample(*a, **k)
        means.append(np.asarray(out))
        return out
    monkeypatch.setattr(jfg, "Logger", Recorder)
    monkeypatch.setattr(jfg.task_model, "task_model_init", init_rec)
    monkeypatch.setattr(jax_cb, "batched_sample_vectors", sample_rec)
    jfg.run_finetune_edge_parallel(ds_j, cfg, _mesh(2))
    assert len(inits) == 1 and len(means) == int(kmeans)
    assert bool(inits[0][1]["vq"]["initted"]) == (not kmeans)
    inp = dict(ds=ds_p, cfg=pc, init=inits[0])
    if kmeans:
        inp["means"] = means[0]
    outs = mesh.spawn(edge_parallel_workers.run_checks, 2, "cpu", inp)
    assert outs[0]["digest"] == outs[1]["digest"]
    assert [len(o["kmeans"]) for o in outs] == [int(kmeans), 0]
    for o in outs:
        assert o["backend"] == "gloo" and o["world"] == 2
        assert len(o["history"]) == len(logged) == cfg.epochs
        for h, (loss, res) in zip(o["history"], logged):
            np.testing.assert_allclose(h["losses"]["loss"], loss["loss"],
                                       rtol=1e-5, atol=0)
            assert h["accs"] == [res["train"], res["val"], res["test"]]
            # the two layers' sums and degrees, layer 2's sum again in
            # the backward (layer 1 reads the features, which need no
            # gradient), the gradients' and the buffers' means
            assert h["step_allreduces"] == 7
            # the two layers' sums and degrees
            assert h["eval_allreduces"] == 4


def test_runner_learns_the_task():
    """``tests/test_parallel.py``'s edge-parallel convergence check on the
    port: test accuracy above 75 after 50 epochs."""
    _, pc = _cfgs(False, epochs=50, early_stop=25)
    _, ds_p = _datasets()
    outs = mesh.spawn(edge_parallel_workers.run_checks, 2, "cpu",
                      dict(ds=ds_p, cfg=pc))
    assert outs[0]["digest"] == outs[1]["digest"]
    for o in outs:
        assert o["best"]["test"]["mean"] > 75, o["best"]
