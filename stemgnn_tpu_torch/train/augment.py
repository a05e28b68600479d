"""Graph augmentations of the pretrain step as fixed-shape ops (counterpart
of ``stemgnn_tpu/train/augment.py``; the reference's pretrain.py:41-45):

  * :func:`mask_feature` — PyG ``mask_feature`` in mode 'col': whole
    feature columns zeroed with probability p;
  * :func:`dropout_edges_undirected_seeded` — ``dropout_adj(p,
    force_undirected=True)`` as a keep mask: one pair-hash draw per
    undirected pair (``ops.pairhash``), so the fused aggregation's
    ``drop_hash`` drops exactly the same edges from the same seed.

Edges are masked out instead of removed, so shapes stay static.  Draws come
from an explicit ``torch.Generator``; they are not JAX's ``jax.random``
numbers (parity tests hand both sides the same draws).
"""

from __future__ import annotations

import torch

from stemgnn_tpu_torch.ops.pairhash import pair_hash_keep

INT32_MAX = 2 ** 31 - 1


def feature_keep(num_cols: int, p: float, generator=None, device=None):
    """[num_cols] bool: each feature column kept with probability 1 - p."""
    u = torch.rand(num_cols, generator=generator, device=device)
    return u < 1.0 - p


def mask_feature(x, keep):
    """``x`` with the columns that ``keep`` [D] drops zeroed."""
    return torch.where(keep[None, :], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))


def dropout_edge_seed(generator=None, device=None):
    """The int64 0-dim seed of the pair hash, uniform in [0, 2^31 - 1) as
    JAX's ``dropout_edge_seed`` draws it; shared by the materialized keep
    mask and the fused ``drop_hash`` path."""
    return torch.randint(0, INT32_MAX, (), generator=generator, device=device)


def dropout_edges_undirected_seeded(seed, senders, receivers, edge_mask,
                                    p: float):
    """The edge mask with the pairs the hash drops at ``(seed, p)``
    cleared."""
    return edge_mask & pair_hash_keep(seed, senders, receivers, p)
