"""Codebook primitives of the VQ (counterpart of
``stemgnn_tpu/vq/codebook.py`` and of ``_orthogonal_loss`` in
``stemgnn_tpu/vq/quantize.py``): l2 normalization, distances, the affine
codebook map, the orthogonal regularizer of a learnable codebook and the
k-means of the codebook's init.  EMA statistics and dead-code expiry are
not ported."""

from __future__ import annotations

import torch


def l2norm(t, eps: float = 1e-12):
    """F.normalize(p=2, dim=-1) semantics (vq.py:28-29); the norm reduces
    in f32, the divide runs in t's dtype."""
    n = torch.linalg.vector_norm(t.float(), dim=-1, keepdim=True)
    return t / torch.clamp(n, min=eps).to(t.dtype)


def cosine_distances(xh, embed):
    """dist[h, n, c] = <xh[h,n], embed[h,c]> (vq.py:650), f32 scores summed
    in f32 (JAX's ``preferred_element_type=float32``): for bf16 operands on
    CUDA one bf16 product with f32 output (tensor cores; the scores feed
    the argmax only and carry no gradient); elsewhere the operands widened
    to f32, which is exact.  A bf16 product with bf16 output would round
    the scores and move the argmax at near-ties."""
    if xh.is_cuda and xh.dtype == embed.dtype == torch.bfloat16:
        return torch.bmm(xh.detach(), embed.detach().transpose(1, 2),
                         out_dtype=torch.float32)
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


def batched_sample_vectors(samples, num: int, mask=None, generator=None):
    """``num`` rows of each codebook's samples [h, n, d], drawn uniformly
    with replacement from the rows ``mask`` [n] keeps (all rows without a
    mask), per codebook (vq.py:106-116; JAX draws the same distribution
    with ``jax.random``)."""
    h, n, d = samples.shape
    if mask is not None:
        w = mask.float()
        idx = torch.stack([torch.multinomial(w, num, replacement=True,
                                             generator=generator)
                           for _ in range(h)])
    else:
        idx = torch.randint(0, n, (h, num), generator=generator,
                            device=samples.device)
    return torch.gather(samples, 1, idx[:, :, None].expand(-1, -1, d))


def _buckets(samples, means, use_cosine_sim: bool, mask):
    """Each sample's nearest mean [h, n] (the largest cosine similarity or
    the smallest squared distance), and ``num_clusters`` (a spare bucket
    past the last mean) for the rows ``mask`` drops."""
    xm = torch.bmm(samples, means.transpose(1, 2))          # [h, n, c]
    if use_cosine_sim:
        dists = xm
    else:
        x2 = (samples ** 2).sum(-1)[:, :, None]
        m2 = (means ** 2).sum(-1)[:, None, :]
        dists = -(x2 + m2 - 2 * xm)
    b = dists.argmax(-1)
    if mask is not None:
        b = torch.where(mask[None, :], b, means.shape[1])
    return b


def _bins_and_sums(samples, b, num_clusters: int, with_sums: bool = True):
    """Samples per bucket [h, c] and their sums [h, c, d], by
    ``scatter_add_`` / ``index_add_`` over the bucket ids (no one-hot);
    the spare bucket of masked rows is dropped."""
    h, n, d = samples.shape
    c1 = num_clusters + 1
    bins = torch.zeros(h, c1, dtype=samples.dtype, device=samples.device)
    bins.scatter_add_(1, b, torch.ones_like(b, dtype=samples.dtype))
    sums = None
    if with_sums:
        flat = (b + torch.arange(h, device=b.device)[:, None] * c1)
        sums = torch.zeros(h * c1, d, dtype=samples.dtype,
                           device=samples.device)
        sums.index_add_(0, flat.reshape(-1), samples.reshape(h * n, d))
        sums = sums.view(h, c1, d)[:, :num_clusters]
    return bins[:, :num_clusters], sums


def kmeans(samples, num_clusters: int, num_iters: int = 10,
           use_cosine_sim: bool = True, mask=None, generator=None,
           means=None):
    """k-means over samples [h, n, d] (vq.py:182-222, JAX
    ``codebook.kmeans``): ``num_iters`` rounds of assigning each sample to
    its nearest mean and moving every mean with samples to their average
    (re-normalized for the cosine codebook); a mean without samples stays.
    ``mask`` [n] drops rows.  The initial means are ``means`` [h, c, d]
    when given, else rows drawn from ``generator``
    (:func:`batched_sample_vectors`).  Returns (means [h, c, d], bins
    [h, c]: the samples of each mean after the last round)."""
    samples = samples.float()
    if means is None:
        means = batched_sample_vectors(samples, num_clusters, mask=mask,
                                       generator=generator)
    means = means.float()
    for _ in range(num_iters):
        b = _buckets(samples, means, use_cosine_sim, mask)
        bins, sums = _bins_and_sums(samples, b, num_clusters)
        new = sums / torch.clamp(bins, min=1.0)[..., None]
        if use_cosine_sim:
            new = l2norm(new)
        means = torch.where((bins == 0)[..., None], means, new)
    b = _buckets(samples, means, use_cosine_sim, mask)
    return means, _bins_and_sums(samples, b, num_clusters, False)[0]
