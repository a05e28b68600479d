"""Codebook primitives of the VQ (counterpart of
``stemgnn_tpu/vq/codebook.py`` and of ``_orthogonal_loss`` in
``stemgnn_tpu/vq/quantize.py``): l2 normalization, distances, code
sampling (argmax, or Gumbel-perturbed with an optional straight-through
softmax), the EMA codebook statistics with Laplace smoothing, the affine
codebook statistics and maps, dead-code expiry, the orthogonal regularizer
of a learnable codebook and the k-means of the codebook's init.

The statistics are dicts of tensors (the VQ's buffers) and the functions
return new dicts, as JAX's do.  Every random draw can be handed in (the
Gumbel noise, the expiry's sample rows); otherwise it is drawn from a
``torch.Generator``.  The cross-replica sums of the JAX functions
(``axis_name``) belong to the multi-GPU path and are not ported."""

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


def gumbel_noise(shape, generator=None, device=None):
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 2 ** -24)))


def sample_codes(logits, *, temperature: float = 1.0,
                 stochastic: bool = False, training: bool = True,
                 noise=None, generator=None):
    """The code ids [h, n] of ``gumbel_sample``: the argmax of ``logits``,
    or in training with ``stochastic`` of ``logits / temperature`` plus
    Gumbel ``noise`` (drawn from ``generator`` when None)."""
    if training and stochastic and temperature > 0:
        if noise is None:
            noise = gumbel_noise(logits.shape, generator, logits.device)
        logits = logits / temperature + noise.to(logits.dtype)
    return logits.argmax(dim=-1)


def code_one_hot(ind, logits, *, temperature: float = 1.0,
                 straight_through: bool = False, training: bool = True):
    """The one-hot [h, n, c] of ``ind``; the straight-through form adds
    ``pi - pi.detach()``, pi the softmax of ``logits / temperature``, so
    gradients reach the logits."""
    one_hot = torch.nn.functional.one_hot(ind, logits.shape[-1]).to(
        logits.dtype)
    if straight_through and temperature > 0 and training:
        pi1 = torch.softmax(logits / temperature, dim=-1)
        one_hot = one_hot + pi1 - pi1.detach()
    return one_hot


def gumbel_sample(logits, *, temperature: float = 1.0,
                  stochastic: bool = False, straight_through: bool = False,
                  training: bool = True, noise=None, generator=None):
    """vq.py:63-100 (JAX ``gumbel_sample``; the reinmax path is not enabled
    by the reference either): (ind [h, n], one_hot [h, n, c]) of
    :func:`sample_codes` and :func:`code_one_hot`."""
    ind = sample_codes(logits, temperature=temperature,
                       stochastic=stochastic, training=training,
                       noise=noise, generator=generator)
    return ind, code_one_hot(ind, logits, temperature=temperature,
                             straight_through=straight_through,
                             training=training)


def laplace_smoothing(x, n_categories: int, eps: float = 1e-5):
    """vq.py:102-104."""
    return (x + eps) / (x.sum(-1, keepdim=True) + n_categories * eps)


def ema(old, new, decay: float):
    """old.lerp_(new, 1 - decay) (vq.py:40-46)."""
    return old * decay + new * (1.0 - decay)


def ema_codebook_update(state: dict, xh, one_hot, *, decay: float,
                        eps: float, use_cosine_sim: bool, mask=None,
                        reduce=None):
    """EMA cluster statistics and the normalized codebook (vq.py:661-682):
    ``cluster_size`` and ``embed_avg`` move toward the batch's bins and
    per-code sums of ``xh`` [h, n, d] (``mask`` [n] drops rows); the new
    codebook is ``embed_avg`` over the Laplace-smoothed sizes (l2-normalized
    for the cosine codebook).  ``reduce`` sums the bins and sums across
    ranks (JAX's ``axis_name``, the reference's all_reduce, vq.py:666,672).
    Returns (new state, new embed)."""
    if mask is not None:
        one_hot = one_hot * mask.to(one_hot.dtype)[None, :, None]
    bins = one_hot.sum(1)
    embed_sum = torch.einsum("hnd,hnc->hcd", xh, one_hot)
    if reduce is not None:
        bins, embed_sum = reduce(bins), reduce(embed_sum)
    cluster_size = ema(state["cluster_size"], bins, decay)
    embed_avg = ema(state["embed_avg"], embed_sum, decay)
    smoothed = laplace_smoothing(cluster_size, cluster_size.shape[-1], eps) \
        * cluster_size.sum(-1, keepdim=True)
    embed = embed_avg / smoothed[..., None]
    if use_cosine_sim:
        embed = l2norm(embed)
    return dict(state, cluster_size=cluster_size, embed_avg=embed_avg), embed


def affine_stats_update(state: dict, xh, embed, *, batch_decay: float,
                        codebook_decay: float, mask=None, reduce=None):
    """EMA of the per-head mean and variance of the batch ``xh`` [h, n, d]
    (the ``mask`` rows) and of the codebook (vq.py:361-411): the first call
    copies them (``affine_initted`` False), later calls move toward them
    with their decays.  ``reduce`` sums the batch moments across ranks
    (JAX's ``axis_name``).  Returns the new state."""
    c_mean = embed.mean(1, keepdim=True)
    c_var = ((embed - c_mean) ** 2).mean(1, keepdim=True)
    if mask is not None:
        m = mask.to(xh.dtype)[None, :, None]
        cnt = torch.clamp(mask.to(xh.dtype).sum(), min=1.0)
        b_sum = (xh * m).sum(1, keepdim=True)
    else:
        cnt = torch.tensor(float(xh.shape[1]), dtype=xh.dtype,
                           device=xh.device)
        b_sum = xh.sum(1, keepdim=True)
    if reduce is not None:
        cnt, b_sum = reduce(cnt), reduce(b_sum)
    b_mean = b_sum / cnt
    sq = (xh - b_mean) ** 2
    if mask is not None:
        sq = sq * mask.to(sq.dtype)[None, :, None]
    v_sum = sq.sum(1, keepdim=True)
    if reduce is not None:
        v_sum = reduce(v_sum)
    b_var = v_sum / cnt
    initted = state["affine_initted"]

    def step(name, new, decay):
        return torch.where(initted, ema(state[name], new, decay), new)
    return dict(state,
                codebook_mean=step("codebook_mean", c_mean, codebook_decay),
                codebook_var=step("codebook_var", c_var, codebook_decay),
                batch_mean=step("batch_mean", b_mean, batch_decay),
                batch_var=step("batch_var", b_var, batch_decay),
                affine_initted=torch.ones_like(initted))


def affine_inverse_transform(stats: dict, xh, eps: float = 1e-5):
    """Map batch vectors into the codebook's distribution for the EMA
    statistics (vq.py:487): (x - batch_mean) * codebook_std / batch_std +
    codebook_mean."""
    c_std = torch.sqrt(torch.clamp(stats["codebook_var"], min=eps))
    b_std = torch.sqrt(torch.clamp(stats["batch_var"], min=eps))
    return (xh - stats["batch_mean"]) * (c_std / b_std) + stats["codebook_mean"]


def sample_indices(h: int, n: int, num: int, mask=None, generator=None,
                   device=None):
    """[h, num] row indices into n rows, uniform with replacement over the
    rows ``mask`` [n] keeps (all rows without a mask), per codebook
    (vq.py:106-116; JAX draws the same distribution with ``jax.random``)."""
    if mask is not None:
        w = mask.float()
        return torch.stack([torch.multinomial(w, num, replacement=True,
                                              generator=generator)
                            for _ in range(h)])
    return torch.randint(0, n, (h, num), generator=generator, device=device)


def expire_dead_codes(state: dict, embed, xh, *, threshold: float,
                      reset_cluster_size: float, use_cosine_sim: bool,
                      mask=None, idx=None, generator=None):
    """Replace the codes whose EMA cluster size fell below ``threshold`` by
    batch rows (vq.py:597-621): the rows ``idx`` [h, C] of ``xh``
    (l2-normalized for the cosine codebook), drawn when None
    (:func:`sample_indices`).  ``embed_avg`` of a replaced code becomes its
    row times ``reset_cluster_size`` and its size ``reset_cluster_size``.
    A no-op when ``threshold <= 0``.  Returns (new state, new embed)."""
    if threshold <= 0:
        return state, embed
    expired = state["cluster_size"] < threshold
    samples = l2norm(xh) if use_cosine_sim else xh
    h, n, d = samples.shape
    if idx is None:
        idx = sample_indices(h, n, embed.shape[1], mask, generator,
                             samples.device)
    sampled = torch.gather(samples, 1,
                           idx.long()[:, :, None].expand(-1, -1, d))
    new_embed = torch.where(expired[..., None], sampled, embed)
    new_avg = torch.where(expired[..., None], sampled * reset_cluster_size,
                          state["embed_avg"])
    new_cs = torch.where(expired, torch.full_like(state["cluster_size"],
                                                  reset_cluster_size),
                         state["cluster_size"])
    return dict(state, cluster_size=new_cs, embed_avg=new_avg), new_embed


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
    """``num`` rows of each codebook's samples [h, n, d], drawn by
    :func:`sample_indices`."""
    h, n, d = samples.shape
    idx = sample_indices(h, n, num, mask, generator, samples.device)
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
