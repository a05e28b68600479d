"""BERT encoder, the ``e5`` text-encoder backend (counterpart of
``stemgnn_tpu/nn/bert.py``).

The reference's ``e5`` option runs ``intfloat/e5-large-v2`` (a BERT-large:
24 post-LN layers, dim 1024, 16 heads, token-type embeddings) and
average-pools the last hidden state over the attention mask WITHOUT an l2
norm.  :class:`BertModel` is its eval-mode forward in plain PyTorch, with
the blocks of :mod:`stemgnn_tpu_torch.nn.distilbert` (the attention norm
is ``att_ln`` here, as in the JAX pytree); weights come from any Hugging
Face ``BertModel`` state dict through :func:`import_hf_bert_state_dict`.
e5 uses the standard uncased BERT vocab.txt, so the WordPiece tokenizer
is DistilBERT's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from stemgnn_tpu_torch.nn.distilbert import (EncoderBlock, Norm, frozen,
                                             as_tensor, hf_dense, hf_norm,
                                             key_bias, load_into,
                                             masked_mean, normal,
                                             strip_prefix)


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    hidden_dim: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


class BertModel(nn.Module):
    """Eval-mode ``BertModel``: [B, L] ids + 0/1 mask (+ token types, zero
    by default) -> the last hidden state [B, L, dim] (JAX
    ``bert_apply``)."""

    def __init__(self, cfg: BertConfig = BertConfig(), generator=None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.word_emb = frozen(normal((cfg.vocab_size, cfg.dim), 0.02,
                                      generator, device))
        self.pos_emb = frozen(normal((cfg.max_position_embeddings, cfg.dim),
                                     0.02, generator, device))
        self.type_emb = frozen(normal((cfg.type_vocab_size, cfg.dim), 0.02,
                                      generator, device))
        self.emb_ln = Norm(cfg.dim, cfg.layer_norm_eps, device)
        self.layers = nn.ModuleList(
            EncoderBlock(cfg.dim, cfg.hidden_dim, cfg.n_heads,
                         cfg.layer_norm_eps, ("att_ln", "out_ln"), generator,
                         device) for _ in range(cfg.n_layers))

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        length = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.emb_ln(F.embedding(input_ids, self.word_emb)
                        + self.pos_emb[None, :length]
                        + F.embedding(token_type_ids, self.type_emb))
        bias = key_bias(attention_mask)
        for layer in self.layers:
            x = layer(x, bias)
        return x


def e5_average_pool(hidden, attention_mask):
    """The reference's e5 ``average_pool``: the attention-masked mean, NO
    l2 normalization."""
    return masked_mean(hidden, attention_mask)


def import_hf_bert_state_dict(sd, cfg: BertConfig, device=None
                              ) -> BertModel:
    """A :class:`BertModel` on ``device`` from a Hugging Face ``BertModel``
    state dict (torch tensors or numpy arrays; a leading ``bert.`` prefix
    is stripped, the unused pooler ignored)."""
    sd = strip_prefix(sd, "bert.")

    def get(name):
        return as_tensor(sd[name])
    named = {"word_emb": get("embeddings.word_embeddings.weight"),
             "pos_emb": get("embeddings.position_embeddings.weight"),
             "type_emb": get("embeddings.token_type_embeddings.weight"),
             **hf_norm(get, "embeddings.LayerNorm", "emb_ln")}
    for i in range(cfg.n_layers):
        p, q = f"encoder.layer.{i}", f"layers.{i}"
        for hf, ours in (("attention.self.query", "q"),
                         ("attention.self.key", "k"),
                         ("attention.self.value", "v"),
                         ("attention.output.dense", "o"),
                         ("intermediate.dense", "ffn1"),
                         ("output.dense", "ffn2")):
            named.update(hf_dense(get, f"{p}.{hf}", f"{q}.{ours}"))
        named.update(hf_norm(get, f"{p}.attention.output.LayerNorm",
                             f"{q}.att_ln"))
        named.update(hf_norm(get, f"{p}.output.LayerNorm", f"{q}.out_ln"))
    return load_into(BertModel(cfg, device="meta"), named, device)
