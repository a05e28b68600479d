"""Codebook primitives used by the eval path of the VQ (counterpart of
``stemgnn_tpu/vq/codebook.py``): l2 normalization, distances and the affine
codebook map.  k-means, EMA statistics and dead-code expiry come with
training."""

from __future__ import annotations

import torch


def l2norm(t, eps: float = 1e-12):
    """F.normalize(p=2, dim=-1) semantics (vq.py:28-29); the norm reduces
    in f32, the divide runs in t's dtype."""
    n = torch.linalg.vector_norm(t.float(), dim=-1, keepdim=True)
    return t / torch.clamp(n, min=eps).to(t.dtype)


def cosine_distances(xh, embed):
    """dist[h, n, c] = <xh[h,n], embed[h,c]> (vq.py:650), f32."""
    return torch.einsum("hnd,hcd->hnc", xh.float(), embed.float())


def euclidean_distances(xh, embed):
    """-cdist (vq.py:31-35,472): higher is closer."""
    x2 = (xh ** 2).sum(-1)[:, :, None]
    e2 = (embed ** 2).sum(-1)[:, None, :]
    xe = torch.einsum("hnd,hcd->hnc", xh.float(), embed.float())
    return -torch.sqrt(torch.clamp(x2 + e2 - 2 * xe, min=0.0))


def affine_transform_embed(stats: dict, embed, eps: float = 1e-5):
    """Map the codebook into the batch distribution (vq.py:466-470):
    (embed - codebook_mean) * batch_std / codebook_std + batch_mean."""
    c_std = torch.sqrt(torch.clamp(stats["codebook_var"], min=eps))
    b_std = torch.sqrt(torch.clamp(stats["batch_var"], min=eps))
    return ((embed - stats["codebook_mean"]) * (b_std / c_std)
            + stats["batch_mean"])
