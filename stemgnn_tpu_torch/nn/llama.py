"""Llama decoder, the ``llama2_*`` text-encoder backend (counterpart of
``stemgnn_tpu/nn/llama.py``).

The reference's ``llama2_7b`` / ``llama2_13b`` options run Hugging Face's
``LlamaForCausalLM``, take the LAST hidden state and mean-pool it over the
sequence, UNMASKED: right-padded EOS positions count in the mean.  Llama 2
is RMSNorm pre-norm blocks, rotary position embeddings (Hugging Face's
rotate-half convention), causal attention (grouped KV heads supported), a
SwiGLU MLP and a final RMSNorm.  :class:`LlamaModel` is its eval-mode
forward in plain PyTorch; weights come from a Hugging Face ``LlamaModel``
or ``LlamaForCausalLM`` state dict through
:func:`import_hf_llama_state_dict`.  Parameters are named after the JAX
pytree, weights ``[in, out]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from stemgnn_tpu_torch.nn.distilbert import (as_tensor, attention, frozen,
                                             load_into, normal, strip_prefix)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008            # SwiGLU inner width
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5


def rms_norm(g, x, eps):
    """JAX ``_rms_norm``: the mean square taken in f32."""
    var = x.float().pow(2).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * g


def rope(q, k, theta):
    """Rotary embeddings of [B, H, L, dh] queries and keys, Hugging Face's
    default convention: rotate-half over the concatenated halves."""
    length, dh = q.shape[2], q.shape[3]
    pos = torch.arange(length, dtype=torch.float32, device=q.device)
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=q.device) / dh))
    freqs = pos[:, None] * inv[None, :]                     # [L, dh/2]
    emb = torch.cat([freqs, freqs], dim=-1)                 # [L, dh]
    cos, sin = emb.cos(), emb.sin()

    def rot_half(t):
        return torch.cat([-t[..., dh // 2:], t[..., : dh // 2]], dim=-1)

    def apply(t):
        return t * cos + rot_half(t) * sin
    return apply(q), apply(k)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, generator=None, device=None):
        super().__init__()
        d, dh = cfg.dim, cfg.dim // cfg.n_heads
        kv = cfg.n_kv_heads * dh

        def w(d_in, d_out):
            # uniform in +-sqrt(1 / in), as the DistilBERT linears
            t = torch.empty(d_in, d_out, device=device)
            if t.device.type != "meta":
                lim = math.sqrt(1.0 / d_in)
                t.uniform_(-lim, lim, generator=generator)
            return frozen(t)
        self.in_norm = frozen(torch.ones(d, device=device))
        self.wq, self.wk, self.wv, self.wo = (w(d, d), w(d, kv), w(d, kv),
                                              w(d, d))
        self.post_norm = frozen(torch.ones(d, device=device))
        self.w_gate, self.w_up = w(d, cfg.hidden_dim), w(d, cfg.hidden_dim)
        self.w_down = w(cfg.hidden_dim, d)


class LlamaModel(nn.Module):
    """Eval-mode decoder: [B, L] ids -> the last hidden state [B, L, dim]
    after the final RMSNorm (Hugging Face's ``hidden_states[-1]``; JAX
    ``llama_apply``).  ``attention_mask`` masks padded KEY positions on top
    of the causal mask.  Weights are drawn from ``generator`` on ``device``
    (embeddings normal * 0.02, projections uniform, norms 1)."""

    def __init__(self, cfg: LlamaConfig = LlamaConfig(), generator=None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.word_emb = frozen(normal((cfg.vocab_size, cfg.dim), 0.02,
                                      generator, device))
        self.final_norm = frozen(torch.ones(cfg.dim, device=device))
        self.layers = nn.ModuleList(LlamaBlock(cfg, generator, device)
                                    for _ in range(cfg.n_layers))

    def forward(self, input_ids, attention_mask=None):
        cfg = self.cfg
        b, length = input_ids.shape
        h, hk = cfg.n_heads, cfg.n_kv_heads
        dh = cfg.dim // h
        x = F.embedding(input_ids, self.word_emb)
        neg = torch.finfo(torch.float32).min
        causal = torch.ones(length, length, dtype=torch.bool,
                            device=x.device).tril()
        bias = torch.where(causal, 0.0, neg)[None, None]
        if attention_mask is not None:
            # both masks add: a masked key above the diagonal reads -inf,
            # as in JAX
            bias = bias + torch.where(attention_mask[:, None, None, :] > 0,
                                      0.0, neg)

        def heads(t, nh):
            return t.reshape(b, length, nh, dh).transpose(1, 2)

        for lp in self.layers:
            xn = rms_norm(lp.in_norm, x, cfg.rms_norm_eps)
            q = heads(xn @ lp.wq, h)
            k = heads(xn @ lp.wk, hk)
            v = heads(xn @ lp.wv, hk)
            q, k = rope(q, k, cfg.rope_theta)
            if hk != h:                                   # grouped KV
                k = k.repeat_interleave(h // hk, dim=1)
                v = v.repeat_interleave(h // hk, dim=1)
            ctx = attention(q, k, v, bias)
            x = x + ctx.transpose(1, 2).reshape(b, length, cfg.dim) @ lp.wo
            xn = rms_norm(lp.post_norm, x, cfg.rms_norm_eps)
            x = x + (F.silu(xn @ lp.w_gate) * (xn @ lp.w_up)) @ lp.w_down
        return rms_norm(self.final_norm, x, cfg.rms_norm_eps)


def llama_mean_pool(hidden):
    """The reference's pooling: the plain mean over the sequence axis,
    right-padded positions INCLUDED."""
    return hidden.mean(1)


def import_hf_llama_state_dict(sd, cfg: LlamaConfig, device=None
                               ) -> LlamaModel:
    """A :class:`LlamaModel` on ``device`` from a Hugging Face
    ``LlamaModel`` / ``LlamaForCausalLM`` state dict; the ``model.`` prefix
    is stripped and the LM head ignored."""
    sd = strip_prefix(sd, "model.")

    def get(name):
        return as_tensor(sd[name])
    named = {"word_emb": get("embed_tokens.weight"),
             "final_norm": get("norm.weight")}
    for i in range(cfg.n_layers):
        p = f"layers.{i}"
        named[f"{p}.in_norm"] = get(f"{p}.input_layernorm.weight")
        named[f"{p}.post_norm"] = get(f"{p}.post_attention_layernorm.weight")
        for hf, ours in (("self_attn.q_proj", "wq"),
                         ("self_attn.k_proj", "wk"),
                         ("self_attn.v_proj", "wv"),
                         ("self_attn.o_proj", "wo"),
                         ("mlp.gate_proj", "w_gate"),
                         ("mlp.up_proj", "w_up"),
                         ("mlp.down_proj", "w_down")):
            named[f"{p}.{ours}"] = get(f"{p}.{hf}.weight").t()
    return load_into(LlamaModel(cfg, device="meta"), named, device)
