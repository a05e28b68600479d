"""The port's data-parallel pretrain (``stemgnn_tpu_torch/parallel/
data_parallel.py``, ``run_pretrain(..., mesh=...)`` and ``pretrain
--data_parallel``) against the JAX package on the CPU, on 2-rank gloo
worlds whose ranks run ``tests/halo_workers.py`` (JAX on two of the fake
CPU devices of ``tests/conftest.py``).  JAX's draws are handed to the
port, as ``tests/test_torch_port_minibatch.py`` hands them.

  * One step on two different batches without BatchNorm equals the mean
    of the two single-rank steps (the averaged gradients, SGD at lr 1 so
    the parameters move by them), the metrics their mean; the parameters
    bit-equal across ranks.
  * One step with BatchNorm (its moments, the student's and the
    teacher's, summed across the ranks) against JAX's
    ``make_dp_pretrain_step(..., indexed=True)``: the metrics and the
    averaged gradients before the clip (JAX's captured by an optax
    transformation chained first) to 1e-5 of each tensor's largest entry.
  * ``run_pretrain(mesh=...)`` for 2 epochs (3 steps each: 6 batches
    dealt in pairs) against JAX's ``run_pretrain(mesh=...)``: each epoch's
    mean losses to 1e-5, every parameter and the teacher after it to 1e-4.
  * ``python -m stemgnn_tpu_torch.pretrain --data_parallel --device cpu``
    as a 2-process world from torchrun's variables (``env://`` on a
    localhost port): one checkpoint, rank 0's lines.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import halo_workers
from stemgnn_tpu.core.graph import make_indexed_graph as jax_make_indexed
from stemgnn_tpu.data import synthetic as jax_synthetic
from stemgnn_tpu.data.merge import merge_datasets as jax_merge
from stemgnn_tpu.parallel.data_parallel import (make_dp_pretrain_step,
                                                stack_graphs)
from stemgnn_tpu.parallel.mesh import make_mesh
from stemgnn_tpu.train import pretrain_loop as jax_loop
from stemgnn_tpu.train.optim import make_optimizer as jax_optimizer
from stemgnn_tpu_torch.data import sampler as port_sampler
from stemgnn_tpu_torch.data import synthetic as port_synthetic
from stemgnn_tpu_torch.data.merge import merge_datasets as port_merge
from stemgnn_tpu_torch.models.pretrain import pretrain_forward
from stemgnn_tpu_torch.parallel import mesh
from stemgnn_tpu_torch.train import pretrain_loop as port_loop
from stemgnn_tpu_torch.utils.convert import pretrain_from_jax
from test_torch_port_minibatch import (BS, _capture, _jax_cfg, _jax_draws,
                                       _jax_init, _leaves, _node_ds, _np,
                                       _port_cfg, _tables)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def _batches(merged, n, count):
    """``count`` sampled batches of ``merged`` (the port's sampler, which
    equals JAX's)."""
    csc = port_sampler.CSCGraph.from_edge_index(merged["edge_index"], n)
    it = port_sampler.NeighborBatchIterator(
        csc, merged["x"], merged["xe"], np.arange(n), BS, [5, 5],
        np.random.default_rng(0), drop_last=True)
    return [item[0] for item, _ in zip(it, range(count))]


def _jax_ig(ig):
    return jax_make_indexed(
        ig.node_ids[:ig.n_node], ig.senders[:ig.n_edge],
        ig.receivers[:ig.n_edge], xe_ids=ig.xe_ids[:ig.n_edge],
        node_pad_to=ig.num_nodes_padded, edge_pad_to=ig.num_edges_padded)


def _jax_mesh():
    return make_mesh(devices=np.asarray(jax.devices()[:WORLD]))


def _leaves_of(tree):
    return _leaves(_np(tree))


def _step_inputs(cfg, key):
    merged = port_merge([_node_ds(port_synthetic)])
    batches = _batches(merged, 400, WORLD)
    rngs = jax.random.split(key, WORLD)
    draws = [_jax_draws(cfg, ig, k) for ig, k in zip(batches, rngs)]
    return merged, batches, rngs, draws


def test_dp_step_is_the_mean_of_single_rank_steps():
    """Without BatchNorm the ranks share nothing but the averages: the
    step's gradients are the mean of the single-rank gradients (1e-5 of
    each tensor's largest entry), its metrics the mean of theirs."""
    cfg = _jax_cfg()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, normalize="none"))
    (params, teacher, state), _, _ = _jax_init(cfg)
    merged, batches, _, draws = _step_inputs(cfg, jax.random.PRNGKey(4))
    pc = _port_cfg(cfg)
    tables = _tables(merged)
    outs = mesh.spawn(halo_workers.dp_step_checks, WORLD, "cpu", dict(
        cfg=pc, init=(params, teacher, state), batches=batches,
        tables=tables, bs=BS, draws=draws))
    assert outs[0]["digest"] == outs[1]["digest"]
    singles, losses = [], []
    for ig, d in zip(batches, draws):
        model, teach = pretrain_from_jax(params, teacher, state, pc)
        g = port_loop.batch_graph(ig, *tables, "cpu", with_layout=False)
        loss, parts, _ = pretrain_forward(
            model, teach, pc, port_loop.augmented(pc, g, d), g, bs=BS,
            draws=d)
        loss.backward()
        singles.append(_leaves_of(halo_workers._grad_tree(
            model, teach, {k: torch.zeros_like(p) if p.grad is None
                           else p.grad for k, p in
                           model.named_parameters()})))
        losses.append({**{k: float(v.detach()) for k, v in parts.items()},
                       "loss": float(loss.detach())})
    got = _leaves_of(outs[0]["grads"])
    for path in got:
        want = (singles[0][path] + singles[1][path]) / 2
        top = float(np.abs(want).max())
        np.testing.assert_allclose(got[path], want, rtol=0,
                                   atol=1e-5 * top + 1e-8, err_msg=path)
    for k, v in outs[0]["metrics"].items():
        np.testing.assert_allclose(v, (losses[0][k] + losses[1][k]) / 2,
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_dp_step_matches_jax():
    """The SAGE biases ``lin_l.b`` feed BatchNorm (their gradient is
    rounding noise on both sides): held against the step's largest
    gradient."""
    cfg = _jax_cfg()
    (params, teacher, state), _, _ = _jax_init(cfg)
    merged, batches, rngs, draws = _step_inputs(cfg, jax.random.PRNGKey(5))
    node_table, edge_table = _tables(merged)
    tx = optax.chain(_capture(), jax_optimizer(
        cfg.lr, cfg.weight_decay, grad_clip=cfg.grad_clip,
        use_scheduler=cfg.use_scheduler, epochs=cfg.epochs,
        steps_per_epoch=1))
    step = make_dp_pretrain_step(cfg, tx, _jax_mesh(), bs=BS, indexed=True)
    _, _, o_j, _, m_j = step(
        params, teacher, tx.init(params), state,
        stack_graphs([_jax_ig(ig) for ig in batches]), rngs,
        jnp.asarray(node_table.numpy()), jnp.asarray(edge_table.numpy()))
    outs = mesh.spawn(halo_workers.dp_step_checks, WORLD, "cpu", dict(
        cfg=_port_cfg(cfg), init=(params, teacher, state), batches=batches,
        tables=(node_table, edge_table), bs=BS, draws=draws))
    assert outs[0]["digest"] == outs[1]["digest"]
    for k, v in m_j.items():
        np.testing.assert_allclose(outs[0]["metrics"][k], float(v),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    got, want = _leaves_of(outs[0]["grads"]), _leaves_of(o_j[0])
    assert set(got) == set(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    for path, leaf in want.items():
        t = top if "lin_l" in path and "'b'" in path else \
            float(np.abs(leaf).max())
        assert float(np.abs(got[path] - leaf).max()) <= 1e-5 * t + 1e-8, \
            path


def test_run_pretrain_data_parallel_matches_jax():
    """JAX ``run_pretrain(mesh=...)`` on ``indexed=True`` batches
    (tests/test_parallel.py:241) and the port's, 2 epochs of 3 steps from
    JAX's initial weights, with JAX's key sequence (one split a step,
    then one key a rank)."""
    cfg = dataclasses.replace(_jax_cfg(epochs=2), batch_size=64)
    pj, tj, _, hj = jax_loop.run_pretrain(
        jax_merge([_node_ds(jax_synthetic)]), cfg, weights=[1.0],
        verbose=False, mesh=_jax_mesh())
    (params, teacher, state), key, _ = _jax_init(cfg)
    merged = port_merge([_node_ds(port_synthetic)])
    # every batch of both epochs in the loop's order (the loop's rng)
    csc = port_sampler.CSCGraph.from_edge_index(merged["edge_index"], 400)
    rng = np.random.default_rng(cfg.seed)
    draws = [[] for _ in range(WORLD)]
    for _ in range(cfg.epochs):
        seeds = port_sampler.get_train_node_idx(merged["ptr"], [1.0], rng)
        it = iter(port_sampler.NeighborBatchIterator(
            csc, merged["x"], merged["xe"], seeds, cfg.batch_size, [5, 5],
            rng, drop_last=True))
        while True:
            group = [next(it, None) for _ in range(WORLD)]
            if group[-1] is None:
                break
            key, k = jax.random.split(key)
            for r, (item, kr) in enumerate(zip(group, jax.random.split(
                    k, WORLD))):
                draws[r].append(_jax_draws(cfg, item[0], kr))
    assert len(draws[0]) == 6
    outs = mesh.spawn(halo_workers.dp_run, WORLD, "cpu", dict(
        cfg=_port_cfg(cfg), init=(params, teacher, state), merged=merged,
        draws=draws))
    for ej, ep in zip(hj, outs[0]["history"]):
        for k in ("loss", "feat_recon_loss", "topo_recon_loss",
                  "topo_sem_recon_loss", "sem_recon_loss", "commit_loss"):
            np.testing.assert_allclose(ep[k], ej[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    assert len(outs[0]["history"]) == len(hj) == 2
    for got, want in zip(outs[0]["trees"][:2], (pj, tj)):
        lg, lw = _leaves_of(got), _leaves_of(want)
        assert set(lg) == set(lw)
        for path, leaf in lw.items():
            np.testing.assert_allclose(lg[path], leaf, rtol=1e-4, atol=1e-4,
                                       err_msg=path)
    # the replicas end bit-equal
    for a, b in zip(outs[0]["trees"][:2], outs[1]["trees"][:2]):
        la, lb = _leaves_of(a), _leaves_of(b)
        for path in la:
            assert np.array_equal(la[path], lb[path]), path


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_pretrain_cli_data_parallel_under_torchrun_variables():
    """Each process one rank of torchrun's world: 2 steps of 2 batches,
    the checkpoints written once by rank 0, which alone prints."""
    run_id = f"test_dp_{uuid.uuid4().hex[:8]}"
    root = os.path.join(ROOT, "ckpts", "pretrain_model", run_id)
    argv = [sys.executable, "-m", "stemgnn_tpu_torch.pretrain",
            "--pretrain_dataset", "cora_synthetic", "--feat_dim", "16",
            "--hidden_dim", "16", "--code_dim", "16", "--codebook_size", "8",
            "--codebook_head", "2", "--pretrain_batch_size", "256",
            "--epochs", "1", "--max_steps", "2", "--data_parallel",
            "--pretrain_run_id", run_id, "--device", "cpu"]
    port = _free_port()
    procs = []
    try:
        for r in range(WORLD):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(WORLD),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(WORLD),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=300) for p in procs]
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err[-3000:]
        assert "Data-parallel over 2 devices" in outs[0][0]
        assert "[pretrain] epoch 1/1 (" in outs[0][0]
        assert "[pretrain] epoch" not in outs[1][0]
        assert sorted(os.listdir(root)) == ["config.json", "encoder_1.npz",
                                            "full_1.npz", "vq_1.npz"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        import shutil
        shutil.rmtree(root, ignore_errors=True)


def test_launch_reports_each_ranks_kernel_launches():
    """``launch_dp_pretrain``'s records carry each rank's kernel launches
    over its run, counted from zero just before it: none on this path,
    which builds no layout."""
    from stemgnn_tpu_torch.ops import scatter
    from stemgnn_tpu_torch.parallel.data_parallel import launch_dp_pretrain
    cfg = dataclasses.replace(_port_cfg(_jax_cfg(epochs=1)), batch_size=64)
    stale = next(iter(scatter.launch_counts))
    scatter.launch_counts[stale] = 5
    recs = launch_dp_pretrain(port_merge([_node_ds(port_synthetic)]), cfg,
                              "cpu", world=1, weights=[1.0], max_steps=1,
                              verbose=False)
    assert [r["rank"] for r in recs] == [0]
    assert recs[0]["launches"] == {k: 0 for k in scatter.KERNELS}
    assert len(recs[0]["history"]) == 1
