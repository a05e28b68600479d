"""DistilBERT sentence encoder (counterpart of
``stemgnn_tpu/nn/distilbert.py``).

The reference encodes node, edge and class texts with the sentence
transformer ``multi-qa-distilbert-cos-v1``: a 6-layer DistilBERT (dim 768,
12 heads, exact GELU, post-LayerNorm, no token-type embeddings), then a
masked mean pool and an l2 norm.  :class:`DistilBertModel` is its eval-mode
forward in plain PyTorch: the products are ``torch.matmul``, the softmax
and the norms PyTorch's own; no kernel of this package runs here.

Parameters are named after the JAX pytree and keep its layouts
(``layers.0.q.w`` is ``[in, out]``), so weights carry across by name
(``utils/convert.py``).  :func:`import_hf_state_dict` maps a Hugging Face
``DistilBertModel`` state dict onto the module, transposing each weight as
JAX does (a view, not a copy).  The WordPiece tokenizer is the JAX
package's, copied so that its ids and masks are the same bit for bit.
"""

from __future__ import annotations

import math
import re
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class DistilBertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072            # FFN inner width
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12


# --------------------------------------------------------------- modules

def frozen(t):
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` [in, out] (JAX ``_lin_apply``); the init
    of ``_linear``: ``w`` uniform in +-sqrt(1 / in), ``b`` zero."""

    def __init__(self, d_in: int, d_out: int, generator=None, device=None):
        super().__init__()
        lim = math.sqrt(1.0 / d_in)
        w = torch.empty(d_in, d_out, device=device)
        if w.device.type != "meta":
            w.uniform_(-lim, lim, generator=generator)
        self.w = frozen(w)
        self.b = frozen(torch.zeros(d_out, device=device))

    def forward(self, x):
        return torch.addmm(self.b, x.reshape(-1, x.shape[-1]),
                           self.w).reshape(*x.shape[:-1], -1)


class Norm(nn.Module):
    """LayerNorm with gain ``g`` and bias ``b`` (JAX ``_ln_apply``: the
    biased variance, ``eps`` inside the root)."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.g = frozen(torch.ones(dim, device=device))
        self.b = frozen(torch.zeros(dim, device=device))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.g, self.b, self.eps)


def normal(shape, std, generator, device):
    t = torch.empty(shape, device=device)
    return t if t.device.type == "meta" else t.normal_(0.0, std,
                                                       generator=generator)


def key_bias(attention_mask):
    """[B, 1, 1, L]: 0 where a key is kept, ``finfo(float32).min`` where it
    is masked.  An all-zero mask row then softmaxes to uniform weights, as
    in JAX, where ``-inf`` would give NaN."""
    neg = torch.finfo(torch.float32).min
    return torch.where(attention_mask[:, None, None, :] > 0, 0.0, neg)


def attention(q, k, v, bias):
    """Softmax attention over [B, H, L, dh] heads with an additive bias."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(scores + bias, dim=-1), v)


class EncoderBlock(nn.Module):
    """A post-LN transformer block (DistilBERT's and BERT's): attention,
    residual, norm, exact-GELU FFN, residual, norm.  ``norm_names`` are
    the pytree names of its two norms."""

    def __init__(self, dim, hidden_dim, n_heads, eps, norm_names,
                 generator=None, device=None):
        super().__init__()
        self.n_heads = n_heads
        for name in ("q", "k", "v", "o"):
            setattr(self, name, Dense(dim, dim, generator, device))
        self.ffn1 = Dense(dim, hidden_dim, generator, device)
        self.ffn2 = Dense(hidden_dim, dim, generator, device)
        self.norm_names = norm_names
        for name in norm_names:
            setattr(self, name, Norm(dim, eps, device))

    def forward(self, x, bias):
        b, length, dim = x.shape
        h = self.n_heads

        def heads(t):
            return t.reshape(b, length, h, dim // h).transpose(1, 2)
        ctx = attention(heads(self.q(x)), heads(self.k(x)),
                        heads(self.v(x)), bias)
        ctx = ctx.transpose(1, 2).reshape(b, length, dim)
        att_ln, out_ln = (getattr(self, n) for n in self.norm_names)
        x = att_ln(x + self.o(ctx))
        return out_ln(x + self.ffn2(F.gelu(self.ffn1(x))))


class DistilBertModel(nn.Module):
    """Eval-mode ``DistilBertModel``: [B, L] ids + [B, L] 0/1 mask -> the
    last hidden state [B, L, dim] in f32 (JAX ``distilbert_apply``).  The
    init follows ``distilbert_init`` (embeddings normal * 0.02, linears
    uniform, norms 1 / 0), drawn from ``generator``; ``device="meta"``
    allocates nothing, for weights that are loaded with ``assign=True``."""

    def __init__(self, cfg: DistilBertConfig = DistilBertConfig(),
                 generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.word_emb = frozen(normal((cfg.vocab_size, cfg.dim), 0.02,
                                      generator, device))
        self.pos_emb = frozen(normal((cfg.max_position_embeddings, cfg.dim),
                                     0.02, generator, device))
        self.emb_ln = Norm(cfg.dim, cfg.layer_norm_eps, device)
        self.layers = nn.ModuleList(
            EncoderBlock(cfg.dim, cfg.hidden_dim, cfg.n_heads,
                         cfg.layer_norm_eps, ("sa_ln", "out_ln"), generator,
                         device) for _ in range(cfg.n_layers))

    def forward(self, input_ids, attention_mask):
        length = input_ids.shape[1]
        x = self.emb_ln(F.embedding(input_ids, self.word_emb)
                        + self.pos_emb[None, :length])
        bias = key_bias(attention_mask)
        for layer in self.layers:
            x = layer(x, bias)
        return x


def masked_mean(hidden, attention_mask):
    m = attention_mask[..., None].to(hidden.dtype)
    return (hidden * m).sum(1) / torch.clamp(m.sum(1), min=1e-9)


def mean_pool_normalize(hidden, attention_mask):
    """Sentence embedding: attention-masked mean pool + l2 norm (the
    multi-qa-distilbert-cos-v1 head)."""
    emb = masked_mean(hidden, attention_mask)
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1,
                                                      keepdim=True),
                             min=1e-12)


# --------------------------------------------------------------- HF import

def as_tensor(v):
    """A state-dict value (torch tensor or numpy array) as an f32 tensor
    on the CPU."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(v, np.float32))


def strip_prefix(sd, prefix):
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}
    return sd


def load_into(model: nn.Module, named: dict, device=None):
    """``model`` (built on ``meta``) takes the tensors of ``named`` as its
    parameters, moved to ``device``; strict: every name, no other."""
    device = torch.device("cpu") if device is None else device
    model.load_state_dict({k: v.to(device) for k, v in named.items()},
                          strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return model.eval()


def hf_dense(get, prefix, name):
    """The weight (transposed to [in, out], a view) and bias of a HF
    linear under ``prefix`` as ``{name.w, name.b}``."""
    return {f"{name}.w": get(prefix + ".weight").t(),
            f"{name}.b": get(prefix + ".bias")}


def hf_norm(get, prefix, name):
    return {f"{name}.g": get(prefix + ".weight"),
            f"{name}.b": get(prefix + ".bias")}


def import_hf_state_dict(sd, cfg: DistilBertConfig, device=None
                         ) -> DistilBertModel:
    """A :class:`DistilBertModel` on ``device`` from a Hugging Face
    ``DistilBertModel`` state dict (torch tensors or numpy arrays); a
    leading ``distilbert.`` prefix is stripped."""
    sd = strip_prefix(sd, "distilbert.")

    def get(name):
        return as_tensor(sd[name])
    named = {"word_emb": get("embeddings.word_embeddings.weight"),
             "pos_emb": get("embeddings.position_embeddings.weight"),
             **hf_norm(get, "embeddings.LayerNorm", "emb_ln")}
    for i in range(cfg.n_layers):
        p, q = f"transformer.layer.{i}", f"layers.{i}"
        for hf, ours in (("attention.q_lin", "q"), ("attention.k_lin", "k"),
                         ("attention.v_lin", "v"),
                         ("attention.out_lin", "o"), ("ffn.lin1", "ffn1"),
                         ("ffn.lin2", "ffn2")):
            named.update(hf_dense(get, f"{p}.{hf}", f"{q}.{ours}"))
        named.update(hf_norm(get, f"{p}.sa_layer_norm", f"{q}.sa_ln"))
        named.update(hf_norm(get, f"{p}.output_layer_norm", f"{q}.out_ln"))
    return load_into(DistilBertModel(cfg, device="meta"), named, device)


# --------------------------------------------------------------- tokenizer

_PUNCT_CATS = ("P",)


def _is_punct(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith(_PUNCT_CATS)


_WS_RE = re.compile(r"\s+")


class WordPieceTokenizer:
    """BERT-style tokenizer: basic cleanup (NFC, lowercase + NFD accent
    stripping, punctuation splitting) then greedy longest-match WordPiece
    with ``##`` continuation pieces (the uncased vocab.txt convention of
    distilbert-base-uncased / multi-qa-distilbert-cos-v1)."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.lower = lowercase
        self.max_chars = max_input_chars_per_word
        self.cls = vocab["[CLS]"]
        self.sep = vocab["[SEP]"]
        self.pad = vocab.get("[PAD]", 0)
        self.unk = vocab["[UNK]"]

    @classmethod
    def from_vocab_file(cls, path: str, **kw):
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    def _basic(self, text: str) -> List[str]:
        out = []
        text = unicodedata.normalize("NFC", text)
        for word in _WS_RE.split(text.strip()):
            if not word:
                continue
            if self.lower:
                word = word.lower()
                word = "".join(c for c in unicodedata.normalize("NFD", word)
                               if unicodedata.category(c) != "Mn")
            cur = []
            for ch in word:
                if _is_punct(ch):
                    if cur:
                        out.append("".join(cur))
                        cur = []
                    out.append(ch)
                else:
                    cur.append(ch)
            if cur:
                out.append("".join(cur))
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.unk]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = self.vocab[sub]
                    break
                end -= 1
            if piece is None:
                return [self.unk]
            pieces.append(piece)
            start = end
        return pieces

    def encode(self, text: str, max_length: int = 512) -> List[int]:
        ids = [self.cls]
        for w in self._basic(text):
            ids.extend(self._wordpiece(w))
            if len(ids) >= max_length - 1:
                break
        ids = ids[: max_length - 1]
        ids.append(self.sep)
        return ids

    def batch(self, texts: Sequence[str], max_length: int = 512,
              pad_multiple: int = 64):
        """Tokenize + pad to a shared length: ``(ids [B, L], mask [B, L])``,
        int32 numpy arrays, with L the smallest multiple of
        ``pad_multiple`` covering the batch, capped at ``max_length``."""
        seqs = [self.encode(t, max_length=max_length) for t in texts]
        lmax = max((len(s) for s in seqs), default=1)
        lpad = min(-(-lmax // pad_multiple) * pad_multiple, max_length)
        ids = np.full((len(seqs), lpad), self.pad, np.int32)
        mask = np.zeros((len(seqs), lpad), np.int32)
        for i, s in enumerate(seqs):
            s = s[:lpad]
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return ids, mask
