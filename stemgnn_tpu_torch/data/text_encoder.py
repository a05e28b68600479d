"""Text -> feature encoders for text-attributed graphs (counterpart of
``stemgnn_tpu/data/text_encoder.py``).

The reference encodes node, edge and class texts with a sentence
transformer ("ST" = multi-qa-distilbert-cos-v1, dim 768), e5-large-v2
(1,024) or Llama 2 (4,096 / 5,120).  Backends:

  * ``hash`` (the default): each lowercase alphanumeric token hashes
    (blake2b, 16 bytes) to a handful of signed dimensions, and each row is
    l2-normalized.  No weights.
  * ``tfidf``: corpus-fit TF-IDF (word uni- and bigrams) + a randomized
    truncated SVD to ``dim``, on the host.  No weights.
  * ``ST``, ``e5``, ``llama2_7b``, ``llama2_13b``: the language models of
    ``nn/{distilbert,bert,llama}.py`` from a local Hugging Face snapshot
    (``ST_MODEL_DIR``, ``E5_MODEL_DIR``, ``LLAMA2_7B_MODEL_DIR``,
    ``LLAMA2_13B_MODEL_DIR``, else a directory under the cache root),
    tokenized on the host and run on the card unless ``device="cpu"``.
    They ignore ``dim``: their width is the model's.

``hash`` and ``tfidf`` equal the JAX package's bit for bit; the neural
backends equal JAX's forwards to float rounding.  Unlike JAX, ``ST``
without a local snapshot raises: there is no fallback to ``transformers``.
"""

from __future__ import annotations

import hashlib
import os
import os.path as osp
import re
import time
from typing import Sequence

import numpy as np
import torch

from stemgnn_tpu_torch.core.device import resolve_device
from stemgnn_tpu_torch.data import importers
from stemgnn_tpu_torch.nn.bert import (BertConfig, e5_average_pool,
                                       import_hf_bert_state_dict)
from stemgnn_tpu_torch.nn.distilbert import (DistilBertConfig,
                                             WordPieceTokenizer,
                                             import_hf_state_dict,
                                             mean_pool_normalize)
from stemgnn_tpu_torch.nn.llama import (LlamaConfig,
                                        import_hf_llama_state_dict,
                                        llama_mean_pool)
from stemgnn_tpu_torch.utils import trace

ENCODER_DIMS = {"hash": 768, "tfidf": 768, "ST": 768, "e5": 1024,
                "llama2_7b": 4096, "llama2_13b": 5120}
NEURAL = ("ST", "st", "e5", "llama2_7b", "llama2_13b")

_TOKEN_RE = re.compile(r"[a-z0-9]+")


class HashTextEncoder:
    """Deterministic hashed bag-of-words embeddings."""

    def __init__(self, dim: int = 768, seeds_per_token: int = 4):
        self.dim = dim
        self.k = seeds_per_token

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            for tok in _TOKEN_RE.findall(t.lower()):
                h = hashlib.blake2b(tok.encode(), digest_size=16).digest()
                v = int.from_bytes(h, "little")
                for j in range(self.k):
                    idx = (v >> (j * 24)) % self.dim
                    sign = 1.0 if (v >> (j * 24 + 23)) & 1 else -1.0
                    out[i, idx] += sign
            n = np.linalg.norm(out[i])
            if n > 0:
                out[i] /= n
        return out


def _randomized_svd(a, k: int, n_iter: int = 4, oversample: int = 16,
                    seed: int = 0):
    """Halko randomized truncated SVD of a (sparse) matrix: (U [n, k],
    S [k]), power iterations re-orthogonalized by QR."""
    rng = np.random.default_rng(seed)
    k_eff = min(k + oversample, min(a.shape))
    y = a @ rng.standard_normal((a.shape[1], k_eff)).astype(np.float32)
    q, _ = np.linalg.qr(y)
    for _ in range(n_iter):
        q, _ = np.linalg.qr(a.T @ q)
        q, _ = np.linalg.qr(a @ q)
    b = q.T @ a                       # [k_eff, vocab] dense
    u, s, _ = np.linalg.svd(np.asarray(b), full_matrices=False)
    u = q @ u
    k = min(k, k_eff)
    return u[:, :k], s[:k]


class TfidfSvdEncoder:
    """TF-IDF (word uni+bigram) + truncated SVD document embeddings (LSA).

    Each :meth:`encode` call fits on its own corpus (node, edge and class
    texts are encoded separately).  Rows are l2-normalized; where the rank
    is below ``dim`` the remaining columns are zero."""

    def __init__(self, dim: int = 768, min_df: int = 2,
                 max_vocab: int = 65536, seed: int = 0):
        self.dim = dim
        self.min_df = min_df
        self.max_vocab = max_vocab
        self.seed = seed

    def _tokens(self, text: str):
        words = _TOKEN_RE.findall(text.lower())
        return words + [f"{a}_{b}" for a, b in zip(words, words[1:])]

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        from collections import Counter

        from scipy import sparse

        docs = [Counter(self._tokens(t)) for t in texts]
        df = Counter()
        for d in docs:
            df.update(d.keys())
        min_df = self.min_df if len(texts) >= 10 else 1
        vocab_items = [(tok, c) for tok, c in df.items() if c >= min_df]
        vocab_items.sort(key=lambda kv: (-kv[1], kv[0]))
        vocab = {tok: i for i, (tok, _) in
                 enumerate(vocab_items[: self.max_vocab])}
        n = len(texts)
        if not vocab or n == 0:
            return np.zeros((n, self.dim), np.float32)
        idf = np.zeros(len(vocab), np.float32)
        for tok, i in vocab.items():
            idf[i] = np.log((1.0 + n) / (1.0 + df[tok])) + 1.0
        rows, cols, vals = [], [], []
        for i, d in enumerate(docs):
            for tok, c in d.items():
                j = vocab.get(tok)
                if j is not None:
                    rows.append(i)
                    cols.append(j)
                    vals.append(c * idf[j])
        a = sparse.csr_matrix(
            (np.asarray(vals, np.float32), (rows, cols)),
            shape=(n, len(vocab)))
        norms = np.sqrt(np.asarray(a.multiply(a).sum(axis=1))).ravel()
        a = sparse.diags(1.0 / np.maximum(norms, 1e-12)).astype(
            np.float32) @ a
        u, s = _randomized_svd(a, self.dim, seed=self.seed)
        emb = u * s[None, :]
        out = np.zeros((n, self.dim), np.float32)
        out[:, : emb.shape[1]] = emb
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-12)


# ------------------------------------------------------- neural backends

class _LanguageModelEncoder:
    """The batch loop of the neural backends: each batch of texts is
    tokenized on the host, copied to the model's device, run and pooled
    there, and copied back (the copy waits for the device, as JAX's
    ``np.asarray`` does).  ``history`` holds the last :meth:`encode`'s
    texts, tokens (the masks' ones; Llama: the ids before the padding to
    64), the positions the model ran, each batch's host ms of tokenizing
    and, on a card, its device ms between CUDA events, and the wall."""

    def __init__(self, model, batch_size: int, max_length: int):
        self.model = model
        self.batch_size = batch_size
        self.max_length = max_length
        self.device = model.word_emb.device
        self.history = {}

    @property
    def dim(self) -> int:
        return self.model.cfg.dim

    def _tokenize(self, chunk):
        """(ids [B, L] int, mask [B, L] 0/1 or None, tokens)."""
        raise NotImplementedError

    def _embed(self, ids, mask):
        raise NotImplementedError

    def _run(self, items, tokenize) -> np.ndarray:
        hist = {"texts": len(items), "tokens": 0, "positions": 0,
                "tokenize_ms": []}
        rec = trace.Recorder(self.device)
        outs = []
        t_all = time.perf_counter()
        for i in range(0, len(items), self.batch_size):
            t0 = time.perf_counter()
            ids, mask, tokens = tokenize(items[i: i + self.batch_size])
            hist["tokenize_ms"].append((time.perf_counter() - t0) * 1e3)
            hist["tokens"] += tokens
            hist["positions"] += int(ids.size)
            ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(
                self.device)
            mask_t = (None if mask is None else
                      torch.from_numpy(np.asarray(mask, np.int64)).to(
                          self.device))
            with trace.span("sg:text.embed", rec), torch.no_grad():
                emb = self._embed(ids_t, mask_t)
            outs.append(emb.cpu().numpy())
        hist["device_ms"] = rec.ms("sg:text.embed")
        hist["wall_s"] = time.perf_counter() - t_all
        self.history = hist
        return (np.concatenate(outs, axis=0) if outs
                else np.zeros((0, self.dim), np.float32))

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        return self._run(list(texts), self._tokenize)


class SentenceEncoder(_LanguageModelEncoder):
    """The ``ST`` backend (JAX ``JaxSentenceEncoder``): DistilBERT, the
    last hidden state, the attention-masked mean pool and the l2 norm of
    multi-qa-distilbert-cos-v1.  :meth:`from_dir` reads a snapshot with
    ``vocab.txt`` plus ``model.safetensors`` or ``pytorch_model.bin``."""

    def __init__(self, model, tokenizer, batch_size: int = 128,
                 max_length: int = 512):
        super().__init__(model, batch_size, max_length)
        self.tokenizer = tokenizer

    @classmethod
    def from_dir(cls, model_dir: str, batch_size: int = 128,
                 max_length: int = 512, device=None):
        tok = WordPieceTokenizer.from_vocab_file(
            osp.join(model_dir, "vocab.txt"))
        sd = _load_local_state_dict(model_dir)
        we = _shape(sd, "embeddings.word_embeddings.weight")
        # the config's 12 heads and 512 positions, as JAX (not inferred)
        cfg = DistilBertConfig(
            vocab_size=we[0], dim=we[1],
            n_layers=_num_layers(sd, r"transformer\.layer\.(\d+)\."),
            hidden_dim=_shape(sd, "ffn.lin1.weight")[0])
        model = import_hf_state_dict(sd, cfg, resolve_device(device))
        return cls(model, tok, batch_size, max_length)

    def _tokenize(self, chunk):
        ids, mask = self.tokenizer.batch(chunk, max_length=self.max_length)
        return ids, mask, int(mask.sum())

    def _embed(self, ids, mask):
        return mean_pool_normalize(self.model(ids, mask), mask)


class E5Encoder(SentenceEncoder):
    """The ``e5`` backend (JAX ``JaxE5Encoder``, intfloat/e5-large-v2
    semantics): BERT, the attention-masked mean pool WITHOUT an l2 norm,
    and no "query:" / "passage:" prefixes (the reference adds none).  The
    heads are ``dim // 64``."""

    def __init__(self, model, tokenizer, batch_size: int = 64,
                 max_length: int = 512):
        super().__init__(model, tokenizer, batch_size, max_length)

    @classmethod
    def from_dir(cls, model_dir: str, batch_size: int = 64,
                 max_length: int = 512, device=None):
        tok = WordPieceTokenizer.from_vocab_file(
            osp.join(model_dir, "vocab.txt"))
        sd = _load_local_state_dict(model_dir)
        we = _shape(sd, "embeddings.word_embeddings.weight")
        cfg = BertConfig(
            vocab_size=we[0], dim=we[1],
            n_layers=_num_layers(sd, r"encoder\.layer\.(\d+)\."),
            n_heads=max(we[1] // 64, 1),
            hidden_dim=_shape(sd, "intermediate.dense.weight")[0])
        model = import_hf_bert_state_dict(sd, cfg, resolve_device(device))
        return cls(model, tok, batch_size, max_length)

    def _embed(self, ids, mask):
        return e5_average_pool(self.model(ids, mask), mask)


class LlamaEncoder(_LanguageModelEncoder):
    """The ``llama2_*`` backends (JAX ``JaxLlamaEncoder``): the Llama
    decoder fed ids only (no attention mask), the last hidden state, the
    UNMASKED sequence mean.  Each batch is padded to the longest text by
    the tokenizer and then to a multiple of 64 with ``pad_id`` (the EOS id,
    or 0), as JAX buckets it: the padding counts in the mean, so the padded
    length changes every embedding.  SentencePiece tokenization is
    ``transformers.AutoTokenizer`` from the same snapshot, imported only
    there."""

    def __init__(self, model, tokenizer=None, batch_size: int = 8,
                 max_length: int = 500, pad_id=None):
        super().__init__(model, batch_size, max_length)
        self.tokenizer = tokenizer
        if pad_id is None:
            pad_id = (tokenizer.eos_token_id if tokenizer is not None
                      else None) or 0
        self.pad_id = pad_id

    @classmethod
    def from_dir(cls, model_dir: str, batch_size: int = 8,
                 max_length: int = 500, device=None):
        # the weights first: a missing snapshot raises before the import
        sd = _load_local_state_dict(model_dir)
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
        tok.pad_token = tok.eos_token
        tok.padding_side = "right"
        tok.truncation_side = "right"
        we = _shape(sd, "embed_tokens.weight")
        dim = we[1]
        n_heads = max(dim // 128, 1)
        kv_dim = _shape(sd, "self_attn.k_proj.weight")[0]
        cfg = LlamaConfig(
            vocab_size=we[0], dim=dim,
            n_layers=_num_layers(sd, r"layers\.(\d+)\."), n_heads=n_heads,
            n_kv_heads=max(kv_dim // (dim // n_heads), 1),
            hidden_dim=_shape(sd, "mlp.gate_proj.weight")[0])
        model = import_hf_llama_state_dict(sd, cfg, resolve_device(device))
        return cls(model, tok, batch_size, max_length)

    def _tokenize(self, chunk):
        enc = self.tokenizer(chunk, padding="longest", truncation=True,
                             max_length=self.max_length)
        ids = np.asarray(enc["input_ids"], np.int32)
        return (self._pad(ids), None,
                int(np.asarray(enc["attention_mask"]).sum()))

    def _pad(self, ids):
        lpad = -(-ids.shape[1] // 64) * 64
        return np.pad(ids, ((0, 0), (0, lpad - ids.shape[1])),
                      constant_values=self.pad_id)

    def _embed(self, ids, mask):
        return llama_mean_pool(self.model(ids))

    def encode_ids(self, ids) -> np.ndarray:
        """Embeddings of texts already tokenized: ``ids`` [N, L], each row
        padded to L as the tokenizer pads a batch to its longest text."""
        ids = np.asarray(ids, np.int32)
        return self._run(ids, lambda chunk: (self._pad(chunk), None,
                                             int(chunk.size)))


def _shape(sd, suffix):
    """The shape of the first state-dict entry whose key ends in
    ``suffix``, as ints."""
    v = sd[next(k for k in sd if k.endswith(suffix))]
    return tuple(int(s) for s in v.shape)


def _num_layers(sd, pattern):
    return 1 + max(int(m.group(1)) for k in sd
                   for m in [re.search(pattern, k)] if m)


def _load_local_state_dict(model_dir: str):
    """``model.safetensors`` when it can be read (the ``safetensors``
    package present), else ``pytorch_model.bin`` (``torch.load`` with
    ``weights_only=True``)."""
    st_path = osp.join(model_dir, "model.safetensors")
    pt_path = osp.join(model_dir, "pytorch_model.bin")
    if osp.exists(st_path):
        try:
            from safetensors.torch import load_file
            return load_file(st_path)
        except ImportError:
            pass
    if osp.exists(pt_path):
        return torch.load(pt_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"no model.safetensors / pytorch_model.bin in {model_dir}")


def default_model_dir(name: str) -> str:
    """Where a neural backend looks without its environment variable: a
    directory under the cache root (``data/importers.DEFAULT_CACHE_ROOT``)."""
    sub = {"ST": "st_model", "e5": "e5_model"}.get(name, name)
    return osp.join(importers.DEFAULT_CACHE_ROOT, sub)


def get_text_encoder(name: str = "hash", dim: int = 768, device=None, **kw):
    """The backend ``name``; ``dim`` sizes ``hash`` and ``tfidf``; the
    neural backends take ``device`` (default: the card), ``model_dir``,
    ``batch_size`` and ``max_length``."""
    if name == "hash":
        return HashTextEncoder(dim=dim, **kw)
    if name == "tfidf":
        return TfidfSvdEncoder(dim=dim, **kw)
    if name in ("ST", "st"):
        model_dir = kw.pop("model_dir", None) or os.environ.get(
            "ST_MODEL_DIR", default_model_dir("ST"))
        need = ("vocab.txt", "model.safetensors or pytorch_model.bin")
        if not osp.exists(osp.join(model_dir, "vocab.txt")):
            raise FileNotFoundError(
                f"the ST text encoder needs a local snapshot of "
                f"sentence-transformers/multi-qa-distilbert-cos-v1 (or any "
                f"DistilBERT): {' and '.join(need)} in {model_dir}; set "
                f"ST_MODEL_DIR to its directory")
        return SentenceEncoder.from_dir(model_dir, device=device, **kw)
    if name == "e5":
        model_dir = kw.pop("model_dir", None) or os.environ.get(
            "E5_MODEL_DIR", default_model_dir("e5"))
        return E5Encoder.from_dir(model_dir, device=device, **kw)
    if name in ("llama2_7b", "llama2_13b"):
        model_dir = kw.pop("model_dir", None) or os.environ.get(
            name.upper() + "_MODEL_DIR", default_model_dir(name))
        return LlamaEncoder.from_dir(model_dir, device=device, **kw)
    raise ValueError(f"unknown text encoder {name}")
