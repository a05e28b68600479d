"""ctypes binding of the native (C++) neighbour sampler (counterpart of
``stemgnn_tpu/data/native_sampler.py``).

The port builds its own copy of the sampler, ``csrc/sampler.cpp``, at first
use through ``utils.native_build`` (``g++ -O3 -march=native``, into
``_build/`` beside this package, keyed by a hash of the source, the flags
and the host CPU's features), and loads it with ``ctypes``;
:func:`sample_subgraph_native` has the contract of the numpy
:func:`~stemgnn_tpu_torch.data.sampler.sample_subgraph`.

There is no quiet fallback: the numpy sampler draws other batches from the
same seed, so a failed build or load raises with the compiler's output
(JAX's shim drops to the numpy path instead).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from stemgnn_tpu_torch.utils import native_build

SOURCE = os.path.join(native_build.CSRC, "sampler.cpp")

_libs: dict = {}


def library_path() -> str:
    """``BUILD_DIR/sampler-<hash>.so`` (``native_build.library_path``)."""
    return native_build.library_path(SOURCE)


def build(force: bool = False) -> str:
    """Compile the sampler library unless it exists (or ``force``); return
    its path.  Raises ``RuntimeError`` with the compiler's output when the
    compiler is missing or fails."""
    return native_build.build(SOURCE, "the native sampler", force=force)


def load():
    """The loaded library (built first when needed), with its ctypes
    signature (JAX ``data/native_sampler.py:50-62``)."""
    path = build()
    lib = _libs.get(path)
    if lib is not None:
        return lib
    try:
        lib = ctypes.CDLL(path)
    except OSError as ex:
        raise RuntimeError(f"cannot load the native sampler {path}: {ex}") \
            from ex
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.stemgnn_sample_subgraph.restype = ctypes.c_int
    lib.stemgnn_sample_subgraph.argtypes = [
        i64p, i32p, i64p, ctypes.c_int64,           # csc
        i64p, ctypes.c_int64,                        # seeds
        i64p, ctypes.c_int64,                        # fanouts
        ctypes.c_uint64,                             # rng seed
        i64p, i64p, ctypes.c_int64,                  # out nodes
        i32p, i32p, i64p, i64p, ctypes.c_int64,      # out edges
    ]
    _libs[path] = lib
    return lib


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def sample_subgraph_native(csc, seeds: np.ndarray, fanouts: Sequence[int],
                           rng_seed: int,
                           node_cap: Optional[int] = None,
                           edge_cap: Optional[int] = None,
                           with_clamped: bool = False):
    """Native fanout sampling with the contract of
    ``data.sampler.sample_subgraph``: (nodes, e_src, e_dst, e_id), plus,
    with ``with_clamped``, whether a capacity cap clamped the sample (an
    exact fill is not a clamp)."""
    lib = load()
    seeds = np.ascontiguousarray(seeds, np.int64)
    fan = np.ascontiguousarray(fanouts, np.int64)
    unbounded = any(int(f) < 0 for f in fanouts)
    if node_cap is None:
        if unbounded:
            node_cap = csc.num_nodes + len(seeds)
        else:
            cap = len(seeds)
            width = len(seeds)
            for f in fanouts:
                width *= max(int(f), 1)
                cap += width
            node_cap = min(cap, csc.num_nodes + len(seeds))
    if edge_cap is None:
        edge_cap = len(csc.src) if unbounded else \
            node_cap * max(max(int(f) for f in fanouts), 1)

    out_nodes = np.empty(node_cap, np.int64)
    out_nn = np.empty(1, np.int64)
    out_esrc = np.empty(edge_cap, np.int32)
    out_edst = np.empty(edge_cap, np.int32)
    out_eid = np.empty(edge_cap, np.int64)
    out_ne = np.empty(1, np.int64)

    indptr = np.ascontiguousarray(csc.indptr, np.int64)
    src = np.ascontiguousarray(csc.src, np.int32)
    eid = np.ascontiguousarray(csc.edge_id, np.int64)

    rc = lib.stemgnn_sample_subgraph(
        _ptr(indptr, ctypes.c_int64), _ptr(src, ctypes.c_int32),
        _ptr(eid, ctypes.c_int64), ctypes.c_int64(csc.num_nodes),
        _ptr(seeds, ctypes.c_int64), ctypes.c_int64(len(seeds)),
        _ptr(fan, ctypes.c_int64), ctypes.c_int64(len(fan)),
        ctypes.c_uint64(rng_seed & (2**64 - 1)),
        _ptr(out_nodes, ctypes.c_int64), _ptr(out_nn, ctypes.c_int64),
        ctypes.c_int64(node_cap),
        _ptr(out_esrc, ctypes.c_int32), _ptr(out_edst, ctypes.c_int32),
        _ptr(out_eid, ctypes.c_int64), _ptr(out_ne, ctypes.c_int64),
        ctypes.c_int64(edge_cap))
    nn, ne = int(out_nn[0]), int(out_ne[0])
    # rc != 0 <=> a capacity cap clamped the sample
    out = (out_nodes[:nn].copy(), out_esrc[:ne].copy(),
           out_edst[:ne].copy(), out_eid[:ne].copy())
    return out + (rc != 0,) if with_clamped else out
