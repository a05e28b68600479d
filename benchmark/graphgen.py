"""The benchmark's traffic generator: an ogbn-arxiv-scale citation graph
from a seed, read from a traffic file's ``graph`` parameters.

A copy of the power-law path of ``stemgnn_tpu_torch.data.synthetic.
synthetic_node_dataset`` (the ``arxiv_synthetic_pl`` dataset): class labels,
source nodes drawn uniformly, destinations drawn by Zipf popularity
``rank^-pref_attach`` (within the source's class with probability
``homophily``, else over all nodes), every edge stored in both directions.
The class-prototype features are made on the card from the seed
(:func:`device_features`), where the original draws 130 M normals on the
host.  The split has the traffic file's train and valid counts (ogbn-arxiv's
published sizes at full scale), drawn from the seed; the rest is test.

Every seed gets the same sizes: the node, edge and class counts, and the
same set of Zipf weights, assigned to the nodes in another order.
"""

from __future__ import annotations

import numpy as np
import torch


def structure(params: dict, seed: int) -> dict:
    """Host arrays of one graph: ``senders`` / ``receivers`` [E] int64 (both
    directions of every drawn pair), ``labels`` [N] int64 and the split
    masks ``train`` / ``valid`` / ``test`` [N] bool."""
    n = int(params["num_nodes"])
    c = int(params["num_classes"])
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    e = n * int(params["avg_degree"]) // 2
    src = rng.integers(0, n, e)
    same = rng.random(e) < float(params["homophily"])
    ranks = 1.0 + rng.permutation(n).astype(np.float64)
    wt = ranks ** (-float(params["pref_attach"]))
    dst = np.empty(e, dtype=np.int64)

    def draw(pool, k):
        if k == 0:
            return np.empty(0, np.int64)
        cdf = np.cumsum(wt[pool])
        return pool[np.searchsorted(cdf / cdf[-1], rng.random(k))]

    src_cls = y[src]
    order = np.argsort(y, kind="stable")
    bounds = np.searchsorted(y[order], np.arange(c + 1))
    for k in range(c):
        sel = same & (src_cls == k)
        dst[sel] = draw(order[bounds[k]:bounds[k + 1]], int(sel.sum()))
    rnd = ~same
    dst[rnd] = draw(np.arange(n), int(rnd.sum()))
    senders = np.concatenate([src, dst])
    receivers = np.concatenate([dst, src])

    split = params["split"]
    perm = rng.permutation(n)
    n_train = min(int(split["train"]), n)
    n_valid = min(int(split["valid"]), n - n_train)
    masks = {}
    for name, ids in (("train", perm[:n_train]),
                      ("valid", perm[n_train:n_train + n_valid]),
                      ("test", perm[n_train + n_valid:])):
        m = np.zeros(n, bool)
        m[ids] = True
        masks[name] = m
    return dict(senders=senders, receivers=receivers, labels=y, **masks)


def device_features(params: dict, labels, feat_dim: int, seed: int,
                    device) -> tuple:
    """``(node_feat [N, D], edge_row [1, D])`` f32 on ``device``: class
    prototypes plus unit noise, ``protos[y] + noise * randn``, as the
    original generator forms them, and the single edge-text row, drawn in
    three calls from a generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c, n = int(params["num_classes"]), int(labels.shape[0])
    protos = torch.randn(c, feat_dim, generator=gen, device=device)
    feats = torch.randn(n, feat_dim, generator=gen, device=device)
    feats.mul_(float(params["noise"]))
    feats.add_(protos[torch.as_tensor(labels, device=device)])
    edge_row = torch.randn(1, feat_dim, generator=gen, device=device)
    return feats, edge_row
