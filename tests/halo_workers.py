"""What the ranks of the halo tests' gloo worlds run (spawned processes:
this module imports torch and the port, never JAX).  Each function takes
the rank's ``Ranks`` and numpy inputs from the test and returns numpy
outputs, which the test holds against the JAX package."""

import numpy as np
import torch

from stemgnn_tpu_torch.parallel import full_graph as pfg
from stemgnn_tpu_torch.parallel import halo as ph
from stemgnn_tpu_torch.train.finetune_loop import _split_params
from stemgnn_tpu_torch.utils.convert import (task_model_from_jax,
                                             task_model_to_jax)


def _block(a, ranks, nb):
    return a[ranks.rank * nb:(ranks.rank + 1) * nb]


def _leaf(x, grad=False):
    return torch.tensor(x, requires_grad=grad)


def _run_grad(fn, x_loc, cot):
    """``fn(x_loc)``, and the gradient of ``sum(fn(x_loc) * cot)`` in
    ``x_loc``."""
    x = _leaf(x_loc, grad=True)
    out = fn(x)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), x.grad.numpy()


def unit_checks(ranks, inp):
    """The exchange, both aggregation routes and the encoders on this
    rank's block (module docstring of tests/test_torch_port_halo.py).
    ``inp["plain"]`` / ``inp["fused"]``: each route's partition pad
    multiple, padded features, cotangents and node mask (the fused route's
    kernels walk blocks of 128 nodes)."""
    me, S = ranks.rank, ranks.world
    out = {}
    pl, fu = inp["plain"], inp["fused"]
    # the exchange and the plain aggregation, edge features per edge
    part, nb, _ = ph.build_halo_partition(
        inp["s"], inp["r"], inp["n"], S, pad_multiple=pl["pm"],
        edge_feat=inp["ef"])
    dev_part = ph.part_to_device(ph.shard_of(part, me), "cpu")
    x_loc = _block(pl["x_pad"], ranks, nb)
    out["halo"], out["halo_grad"] = _run_grad(
        lambda x: ph.halo_exchange(x, dev_part["send_idx"], ranks), x_loc,
        pl["cot_halo"][me])
    out["plain"], out["plain_grad"] = _run_grad(
        lambda x: ph.halo_sage_aggregate(x, dev_part, ranks), x_loc,
        pl["cot"][me])
    # the fused route over this rank's layouts, typed and single-type
    fpart, nb_f, R_f = ph.build_halo_partition(
        inp["s"], inp["r"], inp["n"], S, pad_multiple=fu["pm"],
        xe_ids=inp["xe"])
    (lay_loc, lay_rem), = ph.build_halo_layouts(
        fpart, nb_f, R_f, S, ranks=ranks, edge_chunk=128)
    fdev = ph.part_to_device(ph.shard_of(fpart, me), "cpu")
    xf_loc = _block(fu["x_pad"], ranks, nb_f)
    for tag, table in (("typed", inp["table"]), ("single", None)):
        t = None if table is None else torch.from_numpy(table)
        out[f"fused_{tag}"], out[f"fused_{tag}_grad"] = _run_grad(
            lambda x: ph.halo_sage_aggregate_fused(
                x, fdev, lay_loc, lay_rem, t, ranks, bf16_messages=False),
            xf_loc, fu["cot"][me])
    # the encoders in training (BatchNorm statistics across ranks)
    rev, _, _ = ph.build_halo_partition(inp["r"], inp["s"], inp["n"], S,
                                        pad_multiple=pl["pm"])
    rev_dev = ph.part_to_device(ph.shard_of(rev, me), "cpu")
    for name, enc in inp["encoders"].items():
        enc.train()
        g, p, x = pl, dev_part, x_loc
        kw = {}
        if enc.cfg.backbone != "sage":
            p = {k: v for k, v in dev_part.items() if not k.startswith("ef_")}
        if name == "sage_fused":
            g, p, x = fu, fdev, xf_loc
            kw.update(lay_loc=lay_loc, lay_rem=lay_rem,
                      edge_table=torch.from_numpy(inp["table"]))
        if any(enc.flags):
            kw.update(part_rev=rev_dev, gumbel=[
                torch.from_numpy(a) for a in inp["gumbel"][me]])
        nm = torch.from_numpy(_block(g["node_mask"], ranks, x.shape[0]))
        z, aux = ph.halo_encoder_apply(enc, torch.from_numpy(x), p, ranks,
                                       node_mask=nm, **kw)
        out[f"enc_{name}"] = z.detach().numpy()
        out[f"enc_{name}_env"] = float(aux["env_reg"].detach())
        out[f"enc_{name}_stats"] = [
            {k: np.asarray(v) for k, v in st.items() if k != "layer"}
            for st in aux["moe_stats"]]
        out[f"enc_{name}_bn_mean"] = [bn.mean.numpy().copy()
                                     for bn in enc.norms]
    return out


def train_checks(ranks, inp):
    """One ``make_halo_steps`` train step with SGD at lr 1 from JAX's
    initial task model, then the metrics step (module docstring of
    tests/test_torch_port_halo_train.py)."""
    cfg, ds = inp["cfg"], inp["ds"]
    hg = pfg.prepare_halo_graph(ds, ranks, fused=True, hub_size=0,
                                edge_chunk=128)
    nb = hg.nb

    def block(a):
        full = np.zeros(nb * ranks.world, np.asarray(a).dtype)
        full[:ds.num_nodes] = np.asarray(a)[:ds.num_nodes]
        return torch.from_numpy(_block(full, ranks, nb))
    y = block(ds.labels).long()
    model = task_model_from_jax(*inp["init"], cfg)
    trainable, _ = _split_params(model, cfg)
    opt = torch.optim.SGD(list(trainable.values()), lr=1.0)
    train_step, _, metrics_step = pfg.make_halo_steps(cfg, hg, ranks, y)
    split = ds.splits[0]
    parts = train_step(model, opt, block(split["train"]))
    masks3 = torch.stack([block(split[k]) for k in ("train", "valid",
                                                     "test")])
    params, state = task_model_to_jax(model)
    return {"loss": float(parts["loss"]), "params": params, "state": state,
            "accs": metrics_step(model, masks3).numpy()}


def _draws(d):
    """A rank's draws from numpy (JAX's, handed over by the test)."""
    t = torch.from_numpy
    return dict(feat_keep=t(d["feat_keep"]), drop_seed=t(d["drop_seed"]),
                slots=t(d["slots"]).long(),
                neg=(t(d["neg_u"]).long(), t(d["neg_v"]).long()),
                ortho_ids=t(d["ortho_ids"]).long())


def _grad_tree(model, teacher, grads):
    """``grads`` (by parameter name) in JAX's parameter tree."""
    import copy
    from stemgnn_tpu_torch.utils.convert import pretrain_to_jax
    gm = copy.deepcopy(model)
    with torch.no_grad():
        for k, p in gm.named_parameters():
            p.copy_(grads[k])
    return pretrain_to_jax(gm, teacher)[0]


def halo_pretrain_step_checks(ranks, inp):
    """One ``halo_pretrain_step`` on this rank of the grid from JAX's
    initial trees and with JAX's draws (module docstring of
    tests/test_torch_port_halo_pretrain.py): the losses, the averaged
    gradients before the clip, the parameters after the step and their
    digest."""
    from stemgnn_tpu_torch.parallel import halo_pretrain as php
    from stemgnn_tpu_torch.parallel import mesh as pm
    from stemgnn_tpu_torch.train.pretrain_loop import make_pretrain_optimizer
    from stemgnn_tpu_torch.utils.convert import (pretrain_from_jax,
                                                 pretrain_to_jax)
    cfg, S = inp["cfg"], inp["S"]
    edge, data, _ = pm.grid(ranks, S)
    model, teacher = pretrain_from_jax(*inp["init"], cfg)
    hg = php.prepare_halo_pretrain_graph(
        inp["x"], inp["ei"], edge, xe_ids=inp["xe"], edge_table=inp["table"],
        pad_multiple=128, node_block=128, edge_chunk=128,
        hub_size=inp["hub"])
    nb = hg.nb
    seed_w = torch.from_numpy(
        inp["seed_w"][data][edge.rank * nb:(edge.rank + 1) * nb])
    opt = make_pretrain_optimizer(model, cfg)
    grads = {}
    losses = php.halo_pretrain_step(
        model, teacher, opt, cfg, hg, seed_w,
        _draws(inp["draws"][data][edge.rank]), edge, ranks, grads_out=grads)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": _grad_tree(model, teacher, grads),
            "params": pretrain_to_jax(model, teacher),
            "digest": php.params_digest(model, teacher),
            "grid": (data, edge.rank)}


def halo_pretrain_run(ranks, inp):
    """``run_pretrain_halo`` on this rank with ``inp``'s keywords; the
    draws of each epoch handed over where ``inp`` has them."""
    from stemgnn_tpu_torch.parallel import halo_pretrain as php
    from stemgnn_tpu_torch.utils.convert import pretrain_from_jax
    kw = dict(inp["kw"])
    if "init" in inp:
        kw["model"], kw["teacher"] = pretrain_from_jax(*inp["init"],
                                                       inp["cfg"])
    if "draws" in inp:
        epochs = iter(inp["draws"])
        kw["draw_fn"] = lambda hg, d, e: _draws(next(epochs)[d][e])
    rec = php.run_pretrain_halo(inp["merged"], inp["cfg"], ranks,
                                inp["S"], **kw)
    if "model" in rec:
        from stemgnn_tpu_torch.utils.convert import pretrain_to_jax
        rec["trees"] = pretrain_to_jax(rec.pop("model"), rec.pop("teacher"))
    return rec


def dp_step_checks(ranks, inp):
    """One ``make_dp_pretrain_step`` on this rank's batch with SGD at lr 1
    (so the parameters move by minus the averaged gradient) from the
    given initial trees and draws: the metrics, the gradients as JAX's
    tree and the parameters' digest."""
    from stemgnn_tpu_torch.parallel.data_parallel import make_dp_pretrain_step
    from stemgnn_tpu_torch.parallel.halo_pretrain import params_digest
    from stemgnn_tpu_torch.train.pretrain_loop import batch_graph
    from stemgnn_tpu_torch.utils.convert import pretrain_from_jax
    cfg = inp["cfg"]
    model, teacher = pretrain_from_jax(*inp["init"], cfg)
    graph = batch_graph(inp["batches"][ranks.rank], *inp["tables"], "cpu",
                        with_layout=False)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = make_dp_pretrain_step(cfg, inp["bs"], ranks)
    metrics = step(model, teacher, torch.optim.SGD(model.parameters(),
                                                   lr=1.0), graph,
                   inp["draws"][ranks.rank])
    grads = {k: before[k] - p.detach() for k, p in model.named_parameters()}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _grad_tree(model, teacher, grads),
            "digest": params_digest(model, teacher)}


def dp_run(ranks, inp):
    """``run_pretrain(..., mesh=ranks)`` from the given initial trees with
    this rank's draws of each step handed over: the history and rank 0's
    trees after the run."""
    from stemgnn_tpu_torch.train.pretrain_loop import run_pretrain
    from stemgnn_tpu_torch.utils.convert import (pretrain_from_jax,
                                                 pretrain_to_jax)
    cfg = inp["cfg"]
    model, teacher = pretrain_from_jax(*inp["init"], cfg)
    draws = iter(inp["draws"][ranks.rank])
    model, teacher, hist = run_pretrain(
        inp["merged"], cfg, weights=[1.0], device="cpu", mesh=ranks,
        model=model, teacher=teacher, draw_fn=lambda g: next(draws),
        verbose=False)
    return {"history": hist, "trees": pretrain_to_jax(model, teacher)}
