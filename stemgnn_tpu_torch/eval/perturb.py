"""Graph perturbations for the robustness evaluations (counterpart of
``stemgnn_tpu/eval/perturb.py``), numpy on the host.

  * ``apply_missing_features`` — Bernoulli-mask feature dims with prob
    ``missing_prob`` on the scoped nodes (test / val+test / all), with
    optional relative-L2 Gaussian noise on the kept dims;
  * ``apply_random_edge_drops`` — make the graph undirected and drop its
    duplicates, then drop candidate edges (those touching a scoped node) per
    undirected pair or per directed edge, never all of them, keeping ``xe``
    aligned.

Both return a changed copy of a :class:`~stemgnn_tpu_torch.data.dataset.
TAGDataset`; the same seed gives the JAX package's arrays bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from stemgnn_tpu_torch.data.dataset import TAGDataset


def apply_missing_features(ds: TAGDataset, split_masks: Dict[str, np.ndarray],
                           *, missing_prob: float = 0.4, seed: int = 1,
                           perturb: str = "valtest",
                           relative_noise_alpha: float = 0.0,
                           relative_noise_seed=None) -> TAGDataset:
    """Zero each scoped node's feature dims with prob ``missing_prob``; with
    ``relative_noise_alpha`` > 0 add Gaussian noise of that share of the
    node's feature norm to its kept dims.  Any ``perturb`` other than
    ``test`` and ``all`` scopes val + test, as in the JAX package."""
    if not (0.0 <= missing_prob <= 1.0):
        raise ValueError(f"Missing probability must be within [0, 1]; "
                         f"got {missing_prob}")
    x = ds.node_text_feat[ds.x].astype(np.float32)   # one row per node
    n, d = x.shape
    if perturb == "test":
        scope = split_masks["test"]
    elif perturb == "all":
        scope = np.ones(n, bool)
    else:
        scope = split_masks["valid"] | split_masks["test"]

    rng = np.random.default_rng(seed)
    drop = (rng.random((n, d)) < missing_prob) & scope[:, None]
    x_new = np.where(drop, 0.0, x)

    alpha = float(relative_noise_alpha)
    if alpha > 0.0:
        keep = (~drop) & scope[:, None]
        rng2 = np.random.default_rng(
            seed if relative_noise_seed is None else relative_noise_seed)
        z = rng2.standard_normal((n, d)).astype(np.float32) * keep
        z_norm = np.clip(np.linalg.norm(z, axis=1, keepdims=True), 1e-12, None)
        base = np.clip(np.linalg.norm(x, axis=1, keepdims=True), 1e-12, None)
        x_new = x_new + alpha * base * (z / z_norm) * keep

    # a per-node feature table: the ids become arange
    return dataclasses.replace(
        ds, node_text_feat=x_new.astype(np.float32), x=np.arange(n))


def apply_random_edge_drops(ds: TAGDataset, split_masks: Dict[str, np.ndarray],
                            *, drop_prob: float = 0.2, seed: int = 1,
                            perturb: str = "test",
                            drop_mode: str = "per_undirected") -> TAGDataset:
    """Drop each candidate edge (``per_edge``) or undirected pair
    (``per_undirected``) with prob ``drop_prob``, keeping at least one.
    ``drop_prob`` <= 0 returns an unchanged copy (the graph as given, not
    made undirected)."""
    drop_prob = float(drop_prob)
    if drop_prob <= 0.0:
        return dataclasses.replace(ds)
    drop_prob = min(drop_prob, 1.0)
    n = ds.num_nodes

    # undirected + coalesced; xe follows the surviving representative edge
    src = np.concatenate([ds.edge_index[0], ds.edge_index[1]])
    dst = np.concatenate([ds.edge_index[1], ds.edge_index[0]])
    xe = np.concatenate([ds.xe, ds.xe])
    key = src.astype(np.int64) * n + dst
    _, uniq = np.unique(key, return_index=True)
    src, dst, xe = src[uniq], dst[uniq], xe[uniq]
    e = src.size

    if perturb == "test":
        scope = split_masks["test"]
    elif perturb in ("valtest", "val_test"):
        scope = split_masks["valid"] | split_masks["test"]
    elif perturb == "all":
        scope = np.ones(n, bool)
    else:
        raise ValueError(f"Unsupported perturb option: {perturb}")

    cand = scope[src] | scope[dst]
    cand_idx = np.nonzero(cand)[0]
    drop_mask = np.zeros(e, bool)
    rng = np.random.default_rng(seed)

    if cand_idx.size:
        if drop_mode == "per_edge":
            r = rng.random(cand_idx.size)
            flags = r < drop_prob
            if flags.all():
                flags[np.argmax(r)] = False    # never drop them all
            drop_mask[cand_idx] = flags
        elif drop_mode == "per_undirected":
            lo = np.minimum(src[cand_idx], dst[cand_idx]).astype(np.int64)
            hi = np.maximum(src[cand_idx], dst[cand_idx]).astype(np.int64)
            keys = lo * n + hi
            uniq_keys, inverse = np.unique(keys, return_inverse=True)
            r = rng.random(uniq_keys.size)
            flags = r < drop_prob
            if flags.all():
                flags[np.argmax(r)] = False
            drop_mask[cand_idx] = flags[inverse]
        else:
            raise ValueError(f"Unsupported drop_mode: {drop_mode}")

    keep = ~drop_mask
    return dataclasses.replace(
        ds, edge_index=np.stack([src[keep], dst[keep]]), xe=xe[keep])
