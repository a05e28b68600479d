"""Plain reference of ``stemgnn-pretrain-sage768-vq4x128-mb1024``:
STEM-GNN's pretrain step on a neighbour-sampled minibatch
(model/pt_model.py, pretrain.py:151-167), in plain PyTorch from
``benchmark.plain``.

Each checked step is repeated on that step's own batch, as the program
sampled it: the padded node ids into the feature table, the batch-local
edge list, the validity of nodes and edges, the seed count (the first
``batch_size`` rows are the seeds), the draws and the dropout generator's
state.  One step: the batch's features gathered from the table; the
column feature mask and the undirected pair-hash edge dropout over the
batch-local ids give the augmented view; the student (2-layer SAGE with
BatchNorm over the batch's nodes, relu and inverted dropout) encodes it;
the 4-head cosine VQ quantizes every node of the batch (straight-through
codes, commitment over every valid node, the orthogonal term); the feature
and the semantic losses read the seed rows, the edge losses sampled edge
slots and random pairs over the batch; the teacher encodes the clean
batch; then the global clip, AdamW with the cosine schedule, and the
teacher's EMA.

The aggregation is the one the configuration states: a message
``relu(x_j + t0)`` in float32, summed in float32 over the valid in-edges
and divided by their count (the program's route without a layout rounds
nothing to bfloat16, so :class:`benchmark.plain.SageMean` does not apply).

The batches and draws the program hands over are checked on their own
(:func:`batch_faults`): the steps cannot be compared on them, as both sides
consume them.

``fault="half_batch"`` leaves every other row (and sampled edge) out of
the losses and takes their means over the rest; ``fault="flip<k>"`` and
``"hubflip<k>"`` give the first step's ``k`` (row, head) pairs nearest to
a code tie their second-best code (``benchmark.plain.flip_rows``).
"""

from __future__ import annotations

import torch

from benchmark import plain

EPS = 1e-15


def _mean(z, g: dict, valid):
    """``out[i] = sum_{valid (j, i)} relu(z_j + t0) / max(#valid, 1)``, in
    float32."""
    m = torch.relu(z.index_select(0, g["senders"]) + g["t0"])
    m = m * valid[:, None].to(m.dtype)
    total = torch.zeros(z.shape, dtype=z.dtype, device=z.device).index_add(
        0, g["receivers"], m)
    count = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    count = count.index_add(0, g["receivers"], valid.to(z.dtype))
    return total / count.clamp(min=1.0)[:, None]


def _encoder(p: dict, prefix: str, x, g: dict, valid, num_layers: int,
             keep_u, dropout: float):
    z = x
    for i in range(num_layers):
        lp = f"{prefix}layers.{i}."
        z = (plain.linear(p, lp + "lin_l", _mean(z, g, valid))
             + plain.linear(p, lp + "lin_r", z))
        z = plain.batch_norm(z, g["node_mask"], p[f"{prefix}norms.{i}.scale"],
                             p[f"{prefix}norms.{i}.bias"])
        if i < num_layers - 1:
            z = torch.relu(z)
            keep = 1.0 - dropout
            z = torch.where(keep_u[i] < keep, z / keep,
                            torch.zeros((), device=z.device))
    return z


def batch_data(data: dict, st: dict) -> dict:
    """One step's batch on the table's device: ``x`` the gathered features
    (zero on padded rows), the batch-local ``senders`` / ``receivers``,
    ``edge_valid``, ``node_mask`` and the edge-text row ``t0``."""
    table = data["table"]
    dev = table.device

    def t(a, dtype=None):
        out = torch.as_tensor(a).to(dev)
        return out if dtype is None else out.to(dtype)
    mask = t(st["node_mask"], torch.bool)
    ids = t(st["node_ids"], torch.long).clamp(0, table.shape[0] - 1)
    x = torch.where(mask[:, None], table.index_select(0, ids),
                    torch.zeros((), device=dev))
    return dict(x=x, senders=t(st["senders"], torch.long),
                receivers=t(st["receivers"], torch.long),
                edge_valid=t(st["edge_mask"], torch.bool), node_mask=mask,
                t0=data["t0"])


def _losses(p, teacher, conf, d, draws, bs, u_student, u_teacher, fault):
    enc, vq = conf["encoder"], conf["vq"]
    x, mask = d["x"], d["node_mask"]
    n_pad = x.shape[0]
    keep_col = draws["feat_keep"]
    xa = torch.where(keep_col[None, :], x, torch.zeros((), device=x.device))
    kept = d["edge_valid"] & plain.pair_keep(
        draws["drop_seed"], d["senders"], d["receivers"], conf["edge_p"])
    z = _encoder(p, "encoder.", xa, d, kept, enc["num_layers"], [u_student],
                 enc["dropout"])
    flip, flip_rows = plain.flip_rows(fault, d, mask)
    xh, q, scores = plain.quantize(p, z, heads=vq["heads"],
                                   code_dim=vq["codebook_dim"], flip=flip,
                                   rows=flip_rows)
    margin = plain.code_margin(scores.detach())[mask]
    rows = mask.clone()
    if fault == "half_batch":
        rows &= torch.arange(n_pad, device=x.device) % 2 == 0
    rf = rows.float()
    sf = rf[:bs]
    commit = (((q - xh) ** 2) * rf[None, :, None]).sum() / (
        rf.sum() * q.shape[0] * q.shape[-1]).clamp(min=1.0)
    vq_loss = (vq["commitment_weight"] * commit
               + vq["orthogonal_reg_weight"]
               * plain.orthogonal_loss(p["vq.embed"], draws["ortho_ids"]))
    codes = plain.from_heads(xh + (q - xh).detach())
    query = plain.linear(p, "vq.project_out", codes)

    recon = plain.linear(p, "feat_dec", query[:bs])
    se = ((recon - x[:bs]) ** 2 * sf[:, None]).sum()
    feat = se / (sf.sum() * x.shape[1]).clamp(min=1.0)

    slots = draws["slots"]
    w = d["edge_valid"][slots].float()
    if fault == "half_batch":
        w = w * (torch.arange(slots.shape[0], device=x.device) % 2 == 0)
    w_sum = w.sum().clamp(min=1.0)
    ps, pr = d["senders"][slots], d["receivers"][slots]
    lq = plain.linear(p, "topo_dec.lin", query)
    pos = torch.sigmoid((lq[ps] * lq[pr]).sum(-1))
    ns, nr = draws["neg"]
    neg = torch.sigmoid((lq[ns] * lq[nr]).sum(-1))
    topo = (-(w * torch.log(pos + EPS)).sum() / w_sum
            - torch.log(1.0 - neg + EPS).mean())
    pred = plain.linear(p, "topo_sem_dec", torch.cat([query[ps], query[pr]],
                                                     dim=-1))
    topo_sem = (w * ((pred - d["t0"]) ** 2).mean(-1)).sum() / w_sum

    with torch.no_grad():
        tz = _encoder(teacher, "teacher.", x, d, d["edge_valid"],
                      enc["num_layers"], [u_teacher], enc["dropout"])
    hproj = plain.linear(p, "sem_projector", query)
    cos = 1.0 - (plain.l2norm(tz[:bs]) * plain.l2norm(hproj[:bs])).sum(-1)
    sem = (cos * sf).sum() / sf.sum().clamp(min=1.0)
    parts = dict(feat_recon_loss=feat, topo_recon_loss=topo,
                 topo_sem_recon_loss=topo_sem, sem_recon_loss=sem,
                 commit_loss=vq_loss)
    return (conf["feat_lambda"] * feat + conf["topo_lambda"] * topo
            + conf["topo_sem_lambda"] * topo_sem + conf["sem_lambda"] * sem
            + vq_loss), margin, parts, z.detach()


def batch_faults(graph: dict, conf: dict, steps: list) -> int:
    """The rules each step's batch and draws break, in plain numpy against
    the graph they were sampled from (``graph``: ``edge_index`` [2, E] on
    the host, ``num_nodes``; a node's feature row is its id): a full batch
    of ``batch_size`` seeds in the first rows and the valid rows before the
    padding; the nodes reached by sampling distinct and none a seed; every
    valid edge an edge of the graph, no pair more often than the graph has
    it; each seed (its first row) and each node first reached at hops
    ``1..L-1`` gets ``min(fanout, in-degree)`` in-edges, every other row
    none; ``slots`` the topo-recon count of edge slots, the negative pairs
    over the valid rows, the feature keep a column mask, the dropout seed
    in ``[0, 2^31 - 1)``, and the orthogonal codes distinct codes."""
    import numpy as np

    def host(a):
        return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    src, dst = (host(a).astype(np.int64) for a in graph["edge_index"])
    n = int(graph["num_nodes"])
    keys, mult = np.unique(dst * n + src, return_counts=True)
    indeg = np.bincount(dst, minlength=n)
    bs, fanout = int(conf["batch_size"]), int(conf["fanout"])
    hops, vq = conf["encoder"]["num_layers"], conf["vq"]
    faults = 0
    for st in steps:
        ids = host(st["node_ids"]).astype(np.int64)
        mask = host(st["node_mask"]).astype(bool)
        emask = host(st["edge_mask"]).astype(bool)
        nv, seeds = int(mask.sum()), int(st["seeds"])
        faults += seeds != bs
        faults += not (mask[:nv].all() and 0 < seeds <= nv)
        v = ids[:nv]
        faults += bool(((v < 0) | (v >= n)).any())
        found = v[seeds:]
        faults += bool(np.unique(found).size != found.size
                       or np.isin(found, v[:seeds]).any())
        s = host(st["senders"]).astype(np.int64)[emask]
        r = host(st["receivers"]).astype(np.int64)[emask]
        if ((s < 0) | (s >= nv) | (r < 0) | (r >= nv)).any():
            faults += 1
            continue
        k, c = np.unique(v[r] * n + v[s], return_counts=True)
        at = np.searchsorted(keys, k).clip(max=keys.size - 1)
        faults += bool((keys[at] != k).any() or (c > mult[at]).any())
        # the rows each hop expands: the seeds' first rows, then the rows
        # first reached by the hop before
        _, first = np.unique(v[:seeds], return_index=True)
        want = np.zeros(nv, np.int64)
        frontier, seen = first, np.zeros(nv, bool)
        seen[:seeds] = True
        for _ in range(hops):
            want[frontier] = np.minimum(fanout, indeg[v[frontier]])
            reached = np.unique(s[np.isin(r, frontier)])
            frontier = reached[~seen[reached]]
            seen[frontier] = True
        faults += bool((np.bincount(r, minlength=nv) != want).any())
        d = st["draws"]
        e_pad = emask.size
        num = max(int(e_pad * conf["topo_recon_ratio"]), 1)
        slots = host(d["slots"])
        faults += bool(slots.shape != (num,) or slots.min() < 0
                       or slots.max() >= e_pad)
        for neg in d["neg"]:
            neg = host(neg)
            faults += bool(neg.shape != (num,) or neg.min() < 0
                           or neg.max() >= nv)
        keep = host(d["feat_keep"])
        faults += (keep.dtype != bool
                   or keep.shape != (conf["encoder"]["input_dim"],))
        faults += not 0 <= int(d["drop_seed"]) < 2 ** 31 - 1
        if vq["codebook_size"] > vq["orthogonal_reg_max_codes"]:
            codes = host(d["ortho_ids"])
            faults += bool(codes.shape != (vq["orthogonal_reg_max_codes"],)
                           or np.unique(codes).size != codes.size
                           or codes.min() < 0
                           or codes.max() >= vq["codebook_size"])
    return int(faults)


def run(conf: dict, data: dict, init: dict, steps: list, *, tf32=False,
        fault=None) -> dict:
    """The reference's ``len(steps)`` steps from ``init`` (the student's
    leaves by the program's names, the teacher's as ``teacher.<name>``),
    each on its own batch (``data``: the feature ``table`` and the
    edge-text row ``t0``; each step: the batch's ids and masks, its
    ``draws`` and ``rng_state``): ``losses`` [float] a step, ``grads1`` the
    first step's clipped gradients, ``params`` every leaf after the last
    step, ``parts`` each step's loss terms, ``margins`` each step's
    smallest code-score margin a valid row, ``z1`` the first step's
    student encoding."""
    student = {k: v.detach().clone() for k, v in init.items()
               if not k.startswith("teacher.")}
    teacher = {k: v.detach().clone() for k, v in init.items()
               if k.startswith("teacher.")}
    opt = plain.AdamW(student, conf["lr"], conf["weight_decay"])
    losses, grads1, margins, parts = [], None, [], []
    fault = fault or ""
    with plain.matmul_precision(tf32):
        for t, st in enumerate(steps):
            d = batch_data(data, st)
            bs = int(st["seeds"])
            shape = (d["x"].shape[0], conf["encoder"]["hidden_dim"])
            u_s, u_t = plain.dropout_draws(st["rng_state"], shape, 2,
                                           d["x"].device)
            leaves = {k: v.requires_grad_(True) for k, v in student.items()}
            loss, margin, part, z = _losses(
                leaves, teacher, conf, d, st["draws"], bs, u_s, u_t,
                fault if t == 0 or "flip" not in fault else None)
            margins.append(margin)
            parts.append({k: float(v.detach()) for k, v in part.items()})
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
            grads = {k: (torch.zeros_like(v) if gr is None else gr)
                     for (k, v), gr in zip(leaves.items(), got)}
            grads = plain.clip_global(grads, conf["grad_clip"])
            if t == 0:
                grads1, z1 = grads, z
            losses.append(float(loss.detach()))
            factor = (plain.cosine_factor(t, conf["epochs"])
                      if conf["use_scheduler"] else 1.0)
            student = opt.step({k: v.detach() for k, v in student.items()},
                               grads, factor)
            dcy = conf["sem_encoder_decay"]
            teacher = {k: dcy * v + (1.0 - dcy) * student[
                "encoder." + k[len("teacher."):]]
                for k, v in teacher.items()}
            del leaves, loss, got, d
    return dict(losses=losses, grads1=grads1, params={**student, **teacher},
                margins=margins, parts=parts, z1=z1)
