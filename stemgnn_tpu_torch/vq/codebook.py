"""Codebook primitives of the VQ (counterpart of
``stemgnn_tpu/vq/codebook.py`` and of ``_orthogonal_loss`` in
``stemgnn_tpu/vq/quantize.py``): l2 normalization, distances, the affine
codebook map and the orthogonal regularizer of a learnable codebook.
k-means, EMA statistics and dead-code expiry are not ported."""

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


def orthogonal_subset(num_codes: int, max_codes, generator=None,
                      device=None):
    """The codes the orthogonal term covers: all of them, or a uniform
    random ``max_codes`` of them without repeats (JAX: the first
    ``max_codes`` of a random permutation)."""
    if not max_codes or num_codes <= max_codes:
        return None
    return torch.randperm(num_codes, generator=generator,
                          device=device)[:max_codes]


def orthogonal_loss(embed, ids=None):
    """``sum(sim^2) / (h * n^2) - 1 / n`` over the cosine similarities of
    the codes ``ids`` (all when None) of each codebook (vq.py:232-237,
    1011-1028); differentiable in ``embed`` [h, C, d]."""
    if ids is not None:
        embed = embed[:, ids]
    h, n = embed.shape[0], embed.shape[1]
    normed = l2norm(embed)
    sim = torch.einsum("hid,hjd->hij", normed, normed)
    return (sim ** 2).sum() / (h * n ** 2) - 1.0 / n
