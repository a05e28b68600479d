"""Self-supervised / ranking losses (counterpart of
``stemgnn_tpu/zoo/losses.py``; reference STEM-GNN/dataset/gp/nn/loss.py)."""

from __future__ import annotations

import torch


def info_nce_loss(mi_mat):
    """InfoNCE over an [N, N] mutual-information matrix: diagonal entries
    are positives, off-diagonal the negatives (gp/nn/loss.py:7-20)."""
    n = mi_mat.shape[0]
    pos = torch.diagonal(mi_mat)
    eye = torch.eye(n, dtype=torch.bool, device=mi_mat.device)
    neg_logsum = torch.logsumexp(mi_mat.masked_fill(eye, -torch.inf), dim=-1)
    return -(pos - neg_logsum).mean()


def cca_loss(h1, h2, lam: float = 1e-3):
    """CCA-SSG-style loss: invariance term + decorrelation penalty (the
    JAX package's stand-in for the reference's eigendecomposition
    ``CCALoss``, gp/nn/loss.py:23-87).  The standard deviation is the
    population one, as ``jnp.std``'s."""
    n = h1.shape[0]
    z1 = (h1 - h1.mean(0)) / (h1.std(0, correction=0) + 1e-6)
    z2 = (h2 - h2.mean(0)) / (h2.std(0, correction=0) + 1e-6)
    c1 = (z1.T @ z1) / n
    c2 = (z2.T @ z2) / n
    inv = ((z1 - z2) ** 2).mean()
    eye = torch.eye(h1.shape[1], dtype=h1.dtype, device=h1.device)
    dec = ((c1 - eye) ** 2).sum() + ((c2 - eye) ** 2).sum()
    return inv + lam * dec


def mrr(scores, target_index):
    """Mean reciprocal rank: ``scores`` [B, C], ``target_index`` [B]."""
    target = torch.gather(scores, 1, target_index.long()[:, None])
    rank = 1.0 + (scores > target).sum(1).to(scores.dtype)
    return (1.0 / rank).mean()
