"""Multi-head vector quantization (counterpart of ``vq_apply`` and
``adopt_ema_embed`` in ``stemgnn_tpu/vq/quantize.py``, :148-310): eval,
training with a frozen codebook (finetune) and training with a learnable
or EMA-updated codebook (pretrain).

project_in -> per-head split -> l2norm (cosine) -> affine statistics'
update (training) and codebook map (when ``affine_param``, euclidean only)
-> distances -> argmax, or Gumbel sampling in training
(``stochastic_sample_codes``, ``straight_through_gumbel``) -> codebook rows
-> project_out.  Shapes: z [N, dim]; per-head xh [H, N', d]; ``embed``
[num_codebooks, C, d]; indices [N, H].

Precision (JAX quantize.py:179-300): the projections run in z's dtype
(bf16 under a bf16 encoder, whatever the VQ's ``compute_dtype``); the
per-head pipeline (xh, the code gather, the straight-through) runs in the
VQ's ``compute_dtype`` (bf16 only with the cosine codebook); the distance
scores are f32 summed in f32, the commitment difference is taken in the
pipeline dtype and squared and summed in f32, and ``quantize`` is f32.
The codebook's gradient through the gathered rows is summed in f32 (JAX's
one-hot product rounds it to bf16 once).

Training: the codes pass straight through (``xh + (q - xh).detach()``) and
``loss`` carries the commitment term over the ``mask`` rows.  With
``freeze_codebook=True`` (finetune) the codebook gets no gradient.  Without
it and with ``effective_learnable`` (``orthogonal_reg_weight > 0``, the
pretrain default, quantize.py:185-186, 265-287) the codebook is trained by
the optimizer: the commitment term reaches it through the selected rows and
the orthogonal term (:func:`~stemgnn_tpu_torch.vq.codebook.
orthogonal_loss`, over a random subset of ``orthogonal_reg_max_codes``
codes) through all of them.  A codebook built with ``kmeans_init`` starts
at zero with ``initted`` False until :func:`vq_kmeans_init` seeds it.

Buffers (JAX's VQ state) move in a training forward without a frozen
codebook, as a PyTorch module's buffers do: the affine statistics
(``affine_param``) before the distances, and with ``ema_update`` the EMA
cluster sizes and sums from the batch (inverse-mapped by the affine
statistics), then dead-code expiry (``threshold_ema_dead_code``), the new
codebook kept in ``embed_target``; :func:`adopt_ema_embed` copies it into
``embed`` after the optimizer's step, as JAX's steps do.  The Gumbel noise
and the expiry's sample rows can be handed in (``gumbel=``,
``expire_idx=``), else they are drawn from ``generator``.

Across ranks ``reduce`` sums the affine batch moments and the EMA bins and
sums (JAX's ``axis_name``: the data-parallel step), and ``commit_reduce``
the commitment term's numerator and count, with its gradient, which makes
it a global masked mean (JAX's ``commit_psum_axis``: a node-sharded run,
the halo finetune and pretrain pass both; quantize.py:148-300).  As in
JAX, the config's ``sync_codebook`` is not read: the caller's ``reduce``
does the syncing.
"""

from __future__ import annotations

import torch
from torch import nn

from stemgnn_tpu_torch.core.config import VQConfig
from stemgnn_tpu_torch.nn import init as inits
from stemgnn_tpu_torch.nn.layers import Linear
from stemgnn_tpu_torch.utils import trace
from stemgnn_tpu_torch.vq import codebook as cb

_AFFINE = ("codebook_mean", "codebook_var", "batch_mean", "batch_var")


class VectorQuantize(nn.Module):
    """Parameters ``project_in``/``project_out``/``embed`` and buffers
    ``embed_avg``/``cluster_size``/``initted`` (+ ``embed_target`` and the
    affine statistics when configured) mirror the JAX ``vq_init`` pytrees."""

    def __init__(self, cfg: VQConfig, generator=None):
        super().__init__()
        if cfg.affine_param and cfg.use_cosine_sim:
            raise ValueError("affine_param is euclidean-only, as in the "
                             "reference (vq.py:361, EuclideanCodebook)")
        self.cfg = cfg
        if cfg.requires_projection:
            self.project_in = Linear(cfg.dim, cfg.codebook_input_dim,
                                     generator=generator)
            self.project_out = Linear(cfg.codebook_input_dim, cfg.dim,
                                      generator=generator)
        h, c, d = cfg.num_codebooks, cfg.codebook_size, cfg.codebook_dim
        if cfg.kmeans_init:
            embed = torch.zeros(h, c, d)
        else:
            embed = inits.kaiming_uniform((h, c, d), fan_in=d,
                                          generator=generator)
            if cfg.use_cosine_sim:
                embed = cb.l2norm(embed)
        self.embed = nn.Parameter(embed)
        self.register_buffer("embed_avg", embed.clone())
        self.register_buffer("cluster_size", torch.zeros(h, c))
        self.register_buffer("initted", torch.tensor(not cfg.kmeans_init))
        if cfg.ema_update:
            self.register_buffer("embed_target", embed.clone())
        if cfg.affine_param:
            for name in _AFFINE:
                init = torch.zeros if name.endswith("mean") else torch.ones
                self.register_buffer(name, init(h, 1, d))
            self.register_buffer("affine_initted", torch.tensor(False))

    def _to_heads(self, xp):
        """[N, H*d] -> [num_codebooks, N', d] (vq.py:885-887)."""
        cfg, n = self.cfg, xp.shape[0]
        if cfg.separate_codebook_per_head:
            return xp.reshape(n, cfg.heads, cfg.codebook_dim).permute(1, 0, 2)
        return xp.reshape(1, n * cfg.heads, cfg.codebook_dim)

    def _from_heads(self, q):
        """Inverse of :meth:`_to_heads` -> [N, H*d] (vq.py:1032-1036)."""
        cfg = self.cfg
        if cfg.separate_codebook_per_head:
            h, n, d = q.shape
            return q.permute(1, 0, 2).reshape(n, h * d)
        return q.reshape(q.shape[1] // cfg.heads, cfg.heads * q.shape[2])

    def forward(self, z, *args, **kwargs):
        """:meth:`_forward` in an ``sg:vq`` span (``utils.trace``)."""
        with trace.span("sg:vq"):
            return self._forward(z, *args, **kwargs)

    def _forward(self, z, mask=None, freeze_codebook: bool = False,
                 with_quantize: bool = True, ortho_ids=None, generator=None,
                 gumbel=None, expire_idx=None, reduce=None,
                 commit_reduce=None):
        """Quantize z [N, dim]: returns ``quantize`` [N, dim] f32 (None
        unless ``with_quantize``), ``indices`` [N, H], ``codes`` [N, H*d],
        ``distances`` and ``loss`` (in training the weighted commitment
        term, plus the weighted orthogonal term when the codebook learns; 0
        in eval).  ``mask`` [N] marks the rows the loss and the statistics
        cover.  ``ortho_ids`` are the codes the orthogonal term samples,
        ``gumbel`` [num_codebooks, N', C] the sampling noise and
        ``expire_idx`` [num_codebooks, C] the rows dead codes take (each
        drawn from ``generator`` when None and needed).  ``reduce`` and
        ``commit_reduce`` sum a tensor across ranks (module docstring)."""
        cfg = self.cfg
        learn = self.training and not freeze_codebook
        dt = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
              and cfg.use_cosine_sim else torch.float32)
        xp = self.project_in(z) if cfg.requires_projection else z
        xh = self._to_heads(xp).to(dt)
        if cfg.use_cosine_sim:
            xh = cb.l2norm(xh)
        embed = self.embed
        if freeze_codebook or not cfg.effective_learnable:
            embed = embed.detach()
        hmask = None
        if mask is not None:
            hmask = (mask if cfg.separate_codebook_per_head
                     else mask.repeat_interleave(cfg.heads))
        if cfg.affine_param:
            if learn:
                with torch.no_grad():
                    self._set_state(cb.affine_stats_update(
                        self._state(_AFFINE + ("affine_initted",)), xh,
                        self.embed.detach(),
                        batch_decay=cfg.affine_param_batch_decay,
                        codebook_decay=cfg.affine_param_codebook_decay,
                        mask=hmask, reduce=reduce))
            embed = cb.affine_transform_embed(self._state(_AFFINE), embed)
        dist = (cb.cosine_distances(xh, embed.to(dt)) if cfg.use_cosine_sim
                else cb.euclidean_distances(xh, embed))
        ind = cb.sample_codes(dist, temperature=cfg.sample_codebook_temp,
                              stochastic=cfg.stochastic_sample_codes,
                              training=self.training, noise=gumbel,
                              generator=generator)
        straight = (self.training and cfg.straight_through_gumbel
                    and cfg.sample_codebook_temp > 0)
        # the [h, N', C] one-hot only where it is read (JAX builds it always)
        one_hot = None
        if straight or (learn and cfg.ema_update):
            one_hot = cb.code_one_hot(
                ind, dist, temperature=cfg.sample_codebook_temp,
                straight_through=cfg.straight_through_gumbel,
                training=self.training)
        if straight:
            # the one-hot product carries the softmax's gradient (vq.py:
            # 655-657)
            quantize_h = torch.einsum("hnc,hcd->hnd", one_hot.to(dt),
                                      embed.to(dt))
        else:
            # batched embedding gather (vq.py:224-228,659), rounded to the
            # pipeline dtype; training's one-hot product picks the same rows
            quantize_h = torch.gather(
                embed, 1,
                ind[:, :, None].expand(-1, -1, embed.shape[-1])).to(dt)
        if learn and cfg.ema_update:
            with torch.no_grad():
                self._ema_update(xh, one_hot.detach(), hmask, expire_idx,
                                 generator, reduce)
        loss = torch.zeros((), device=z.device)
        if self.training:
            # the commitment term trains a learnable codebook too
            commit_q = (quantize_h if learn and cfg.effective_learnable
                        else quantize_h.detach())
            quantize_h = xh + (quantize_h - xh).detach()   # straight through
            if cfg.commitment_weight > 0:
                loss = loss + self._commitment(commit_q, xh, mask,
                                               commit_reduce) \
                    * cfg.commitment_weight
            if learn and cfg.orthogonal_reg_weight > 0:
                if ortho_ids is None:
                    ortho_ids = cb.orthogonal_subset(
                        cfg.codebook_size, cfg.orthogonal_reg_max_codes,
                        generator, self.embed.device)
                loss = loss + cb.orthogonal_loss(self.embed, ortho_ids) \
                    * cfg.orthogonal_reg_weight
        codes = self._from_heads(quantize_h)
        out = None
        if with_quantize:
            out = (self.project_out(codes.to(xp.dtype)).float()
                   if cfg.requires_projection else codes.float())
        indices = (ind.transpose(0, 1) if cfg.separate_codebook_per_head
                   else ind.reshape(-1, cfg.heads))
        return {"quantize": out, "indices": indices, "codes": codes,
                "distances": dist, "loss": loss}

    def _state(self, names) -> dict:
        return {k: getattr(self, k) for k in names}

    def _set_state(self, state: dict):
        for k, v in state.items():
            getattr(self, k).copy_(v)

    def _ema_update(self, xh, one_hot, hmask, expire_idx, generator,
                    reduce=None):
        """The EMA statistics from the batch (in the codebook's own
        distribution under ``affine_param``), dead-code expiry, the new
        codebook into ``embed_target`` (vq.py:485-506, 597-621, 661-682)."""
        cfg = self.cfg
        xh_stats = (cb.affine_inverse_transform(self._state(_AFFINE), xh)
                    if cfg.affine_param else xh)
        state, embed = cb.ema_codebook_update(
            self._state(("cluster_size", "embed_avg")), xh_stats.float(),
            one_hot, decay=cfg.decay, eps=cfg.eps,
            use_cosine_sim=cfg.use_cosine_sim, mask=hmask, reduce=reduce)
        state, embed = cb.expire_dead_codes(
            state, embed, xh.float(), threshold=cfg.threshold_ema_dead_code,
            reset_cluster_size=cfg.threshold_ema_dead_code,
            use_cosine_sim=cfg.use_cosine_sim, mask=hmask, idx=expire_idx,
            generator=generator)
        self._set_state(state)
        self.embed_target.copy_(embed)

    def _commitment(self, q, xh, mask, reduce=None):
        """Mean squared (q - xh) over the ``mask`` rows (vq.py:983-1005),
        over every rank's rows with ``reduce``."""
        se = (q - xh).float() ** 2
        if mask is None and reduce is None:
            return se.sum() / se.numel()
        if mask is None:
            num = se.sum()
            den = torch.tensor(float(se.numel()), device=se.device)
        else:
            m = mask.to(se.dtype)
            if not self.cfg.separate_codebook_per_head:
                m = m.repeat_interleave(self.cfg.heads)
            m = m[None, :, None]
            num = (se * m).sum()
            den = m.sum() * se.shape[0] * se.shape[-1]
        if reduce is not None:
            # both sums in one collective
            num, den = reduce(torch.stack([num, den])).unbind()
        return num / torch.clamp(den, min=1.0)


@torch.no_grad()
def vq_kmeans_init(vq: VectorQuantize, z, mask=None, generator=None,
                   means=None):
    """Seed ``vq``'s codebook by k-means over one batch ``z`` [N, dim]
    (vq.py:573-595, JAX ``vq_kmeans_init``), in place: ``embed`` the
    means, ``embed_avg`` the means times their bins, ``cluster_size`` the
    bins, ``initted`` True.  ``mask`` [N] marks the rows to cluster;
    ``generator`` draws the initial means unless ``means`` [h, c, d] are
    handed in.  Returns the bins [h, c]."""
    cfg = vq.cfg
    xp = vq.project_in(z) if cfg.requires_projection else z
    xh = vq._to_heads(xp).float()
    if cfg.use_cosine_sim:
        xh = cb.l2norm(xh)
    embed, bins = cb.kmeans(xh, cfg.codebook_size, cfg.kmeans_iters,
                            cfg.use_cosine_sim, mask=mask,
                            generator=generator, means=means)
    vq.embed.copy_(embed)
    vq.embed_avg.copy_(embed * bins[..., None])
    vq.cluster_size.copy_(bins)
    vq.initted.fill_(True)
    return bins


@torch.no_grad()
def adopt_ema_embed(vq: VectorQuantize) -> None:
    """Copy the EMA-updated codebook ``embed_target`` into ``embed`` (JAX
    ``adopt_ema_embed``, the reference's in-place ``embed.data.copy_``,
    vq.py:504-506).  Call after each training step when ``ema_update``; a
    no-op for a VQ without the EMA target."""
    if hasattr(vq, "embed_target"):
        vq.embed.copy_(vq.embed_target)
