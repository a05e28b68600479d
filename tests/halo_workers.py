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
