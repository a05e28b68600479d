"""Text -> feature encoders for text-attributed graphs (counterpart of
``stemgnn_tpu/data/text_encoder.py``).

Ported: the ``hash`` backend, the default of the finetune CLI's
``--text_encoder`` and of ``data.chem.mol_dataset_from_smiles``: each
lowercase alphanumeric token hashes (blake2b, 16 bytes) to a handful of
signed dimensions, and each row is l2-normalized.  Its output equals the
JAX package's bit for bit.  The corpus-fit ``tfidf`` backend (ROADMAP Queue
1 item 8) and the neural encoders (item 11) are not ported and raise.
"""

from __future__ import annotations

import hashlib
import re
from typing import Sequence

import numpy as np

ENCODER_DIMS = {"hash": 768, "tfidf": 768, "ST": 768, "e5": 1024,
                "llama2_7b": 4096, "llama2_13b": 5120}

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


def get_text_encoder(name: str = "hash", dim: int = 768, **kw):
    if name == "hash":
        return HashTextEncoder(dim=dim, **kw)
    if name == "tfidf":
        raise NotImplementedError(
            "the tfidf text encoder is not ported (ROADMAP Queue 1 item 8); "
            "use 'hash'")
    if name in ENCODER_DIMS or name == "st":
        raise NotImplementedError(
            f"the neural text encoder {name!r} is not ported (ROADMAP Queue "
            f"1 item 11); use 'hash'")
    raise ValueError(f"unknown text encoder {name}")
