"""Multi-head vector quantization (counterpart of ``vq_apply`` in
``stemgnn_tpu/vq/quantize.py``, :148-300): eval, and training with a frozen
codebook.

project_in -> per-head split -> l2norm (cosine) -> affine codebook map
(when ``affine_param``, euclidean only) -> distances -> argmax -> codebook
gather -> project_out, all in f32.  Shapes: z [N, dim]; per-head xh
[H, N', d]; ``embed`` [num_codebooks, C, d]; indices [N, H].

Training with ``freeze_codebook=True`` (all that finetune uses): the
codebook gets no gradient, the codes pass straight through
(``xh + (q - xh).detach()``) and ``loss`` carries the commitment term over
the ``mask`` rows; EMA and the orthogonal term are off when frozen.  A
learnable codebook (EMA, orthogonal loss, k-means init) and the bf16
pipeline are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from stemgnn_tpu_torch.core.config import VQConfig
from stemgnn_tpu_torch.nn import init as inits
from stemgnn_tpu_torch.nn.layers import Linear
from stemgnn_tpu_torch.vq import codebook as cb

_AFFINE = ("codebook_mean", "codebook_var", "batch_mean", "batch_var")


class VectorQuantize(nn.Module):
    """Parameters ``project_in``/``project_out``/``embed`` and buffers
    ``embed_avg``/``cluster_size``/``initted`` (+ ``embed_target`` and the
    affine statistics when configured) mirror the JAX ``vq_init`` pytrees."""

    def __init__(self, cfg: VQConfig, generator=None):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise NotImplementedError("bf16 VQ compute_dtype is not ported")
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

    def forward(self, z, mask=None, freeze_codebook: bool = False,
                with_quantize: bool = True):
        """Quantize z [N, dim]: returns ``quantize`` [N, dim] f32 (None
        unless ``with_quantize``), ``indices`` [N, H], ``codes`` [N, H*d],
        ``distances`` and ``loss`` (the weighted commitment term in
        training, 0 in eval).  ``mask`` [N] marks the rows the loss
        covers."""
        cfg = self.cfg
        if self.training and not freeze_codebook:
            raise NotImplementedError(
                "VQ training with a learnable codebook (EMA, orthogonal "
                "loss, k-means) is not ported; pass freeze_codebook=True")
        xp = self.project_in(z) if cfg.requires_projection else z
        xh = self._to_heads(xp).float()
        if cfg.use_cosine_sim:
            xh = cb.l2norm(xh)
        embed = self.embed
        if freeze_codebook or not cfg.effective_learnable:
            embed = embed.detach()
        if cfg.affine_param:
            embed = cb.affine_transform_embed(
                {k: getattr(self, k) for k in _AFFINE}, embed)
        dist = (cb.cosine_distances(xh, embed) if cfg.use_cosine_sim
                else cb.euclidean_distances(xh, embed))
        ind = dist.argmax(dim=-1)                        # [num_codebooks, N']
        # batched embedding gather (vq.py:224-228,659); training's one-hot
        # product picks the same rows exactly
        quantize_h = torch.gather(
            embed, 1, ind[:, :, None].expand(-1, -1, embed.shape[-1])).float()
        loss = torch.zeros((), device=z.device)
        if self.training:
            commit_q = quantize_h.detach()          # frozen codebook
            quantize_h = xh + (quantize_h - xh).detach()   # straight through
            if cfg.commitment_weight > 0:
                loss = loss + self._commitment(commit_q, xh, mask) \
                    * cfg.commitment_weight
        codes = self._from_heads(quantize_h)
        out = None
        if with_quantize:
            out = (self.project_out(codes.to(xp.dtype)).float()
                   if cfg.requires_projection else codes.float())
        indices = (ind.transpose(0, 1) if cfg.separate_codebook_per_head
                   else ind.reshape(-1, cfg.heads))
        return {"quantize": out, "indices": indices, "codes": codes,
                "distances": dist, "loss": loss}

    def _commitment(self, q, xh, mask):
        """Mean squared (q - xh) over the ``mask`` rows (vq.py:983-1005)."""
        se = (q - xh).float() ** 2
        if mask is None:
            return se.sum() / se.numel()
        m = mask.to(se.dtype)
        if not self.cfg.separate_codebook_per_head:
            m = m.repeat_interleave(self.cfg.heads)
        m = m[None, :, None]
        den = m.sum() * se.shape[0] * se.shape[-1]
        return (se * m).sum() / torch.clamp(den, min=1.0)
