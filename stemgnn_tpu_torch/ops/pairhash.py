"""Deterministic per-undirected-pair uniform hash (counterpart of
``stemgnn_tpu/ops/pairhash.py``).

One Bernoulli decision per undirected node pair, as a pure function of
(seed, min(a, b), max(a, b)): both directions of an edge hash alike, so one
draw keeps or drops the whole pair (the reference's ``dropout_adj(
force_undirected=True)``, STEM-GNN/pretrain.py:41-45), and the decision can
be taken for any (node, hub) pair, which is what lets the hub-dense
aggregation survive the per-step edge dropout (``ops.fused_sage``
``drop_hash``).

Bit-exact with the JAX package's uint32 arithmetic.  PyTorch has no uint32
arithmetic, so the words live in int64 in [0, 2^32): each 32-bit product is
formed from 16-bit halves of the constant, which never leaves the signed
int64 range, and masked to 32 bits.  The uniform converts the int64 word to
f32, which rounds as JAX's uint32 -> f32 conversion does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _mul32(h, c: int):
    """(h * c) mod 2^32 for int64 words h in [0, 2^32) and a 32-bit
    constant c, without leaving the signed int64 range."""
    lo = h * (c & 0xFFFF)                         # < 2^48
    hi = ((h * (c >> 16)) & 0xFFFF) << 16         # (h * c_hi mod 2^16) 2^16
    return (lo + hi) & _M32


def _as_word(t, device=None):
    t = torch.as_tensor(t, device=device)
    return t.to(torch.int64) & _M32


def pair_hash_bits(seed, a, b):
    """The hash's 32-bit word per (seed, unordered {a, b}) as int64 in
    [0, 2^32); ``a`` and ``b`` broadcast."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, device=a.device)
    lo = _as_word(torch.minimum(a, b))
    hi = _as_word(torch.maximum(a, b))
    s = _as_word(seed, a.device)
    h = _mul32(lo, 0x85EBCA6B) ^ _mul32(hi, 0xC2B2AE35)
    h = h ^ _mul32(s, 0x9E3779B9)
    return _finalize(h)


def _finalize(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def pair_hash_uniform(seed, a, b):
    """Uniform f32 in [0, 1) per (seed, unordered {a, b}); broadcasts."""
    h = pair_hash_bits(seed, a, b)
    return h.to(torch.float32) / torch.tensor(4294967296.0,
                                              dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def keep_threshold(p: float) -> int:
    """The least 32-bit word ``h`` with ``f32(h) / 2^32 >= f32(p)``: the
    keep decision ``pair_hash_uniform >= p`` (compared in f32, as JAX
    compares its f32 uniform with a weakly typed float) is ``bits >= this``,
    because the f32 conversion is monotone.  2^32 keeps nothing."""
    t = np.float32(p) * np.float32(4294967296.0)      # exact: a power of 2
    lo, hi = 0, 1 << 32
    while lo < hi:
        mid = (lo + hi) // 2
        if np.float32(np.int64(mid)) >= t:
            hi = mid
        else:
            lo = mid + 1
    return lo


def pair_hash_keep(seed, a, b, p: float):
    """Bool keep per (seed, unordered {a, b}): ``pair_hash_uniform(seed, a,
    b) >= p``, decided on the integer word."""
    return pair_hash_bits(seed, a, b) >= keep_threshold(float(p))
