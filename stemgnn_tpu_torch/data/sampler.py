"""Host-side neighbour sampling into fixed-shape padded subgraph batches
(counterpart of ``stemgnn_tpu/data/sampler.py``; the reference's PyG
``NeighborLoader`` with ``num_neighbors=[10]*L`` and batches of 1,024 seeds,
STEM-GNN/pretrain.py:151-153, utils/loader.py:5-45).

Per seed batch: sample up to ``fanout`` incoming neighbours per hop, seed
nodes first (so the losses' ``[:bs]`` slices cover the seeds), then pad
nodes and edges to buckets.  The buckets are kept exactly as the JAX
package picks them (16 probe chunks of a ``default_rng(0xC0FFEE)``
permutation, the spread-scaled margin, the cache on the CSC graph,
escalation and truncation), although PyTorch does not recompile for a new
shape: the padded edge count sets the number of topo-recon slots, so other
buckets would give other losses.

The native sampler (``data.native_sampler``) is the default and raises when
it cannot be built; ``use_native=False`` takes the numpy path, which draws
other batches.  Also hosts the weighted multi-dataset seed resampling
(``get_train_node_idx``, STEM-GNN/dataset/process_datasets.py:186-198).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from stemgnn_tpu_torch.core.graph import make_indexed_graph, round_up
from stemgnn_tpu_torch.data import native_sampler

_TRUNC_WARNED = False   # one bucket-saturation warning per process


@dataclass
class CSCGraph:
    """Adjacency by destination: the in-edges of node i are
    ``edge_id[indptr[i]:indptr[i+1]]`` with sources ``src[...]``."""
    indptr: np.ndarray        # [N+1]
    src: np.ndarray           # [E] source node per in-edge (sorted by dst)
    edge_id: np.ndarray       # [E] original edge index (for xe lookup)
    num_nodes: int

    @staticmethod
    def from_edge_index(edge_index: np.ndarray, num_nodes: int) -> "CSCGraph":
        dst = edge_index[1]
        order = np.argsort(dst, kind="stable")
        sorted_dst = dst[order]
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.add.at(indptr, sorted_dst + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSCGraph(indptr=indptr, src=edge_index[0][order],
                        edge_id=order.astype(np.int64), num_nodes=num_nodes)


def sample_subgraph(csc: CSCGraph, seeds: np.ndarray, fanouts: Sequence[int],
                    rng: np.random.Generator):
    """Fanout-sample incoming neighbours per hop (without replacement when
    the degree exceeds the fanout, else every in-edge).  Returns (nodes
    [n], edge_src_local, edge_dst_local, edge_id) with the seeds in
    ``nodes[:len(seeds)]``; a duplicate seed keeps its first local id and
    expands once, and discovered nodes are numbered after every seed
    slot."""
    seeds = np.asarray(seeds, dtype=np.int64)
    node_list = [seeds]
    local_of = {}
    frontier = []
    for i, v in enumerate(seeds):
        if int(v) not in local_of:
            local_of[int(v)] = i
            frontier.append(int(v))
    frontier = np.asarray(frontier, dtype=np.int64)
    next_local = len(seeds)
    e_src, e_dst, e_ids = [], [], []

    for fanout in fanouts:
        next_frontier = []
        for v in frontier:
            lo, hi = csc.indptr[v], csc.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            if fanout >= 0 and deg > fanout:
                sel = rng.choice(deg, size=fanout, replace=False) + lo
            else:
                sel = np.arange(lo, hi)
            srcs = csc.src[sel]
            eids = csc.edge_id[sel]
            dst_local = local_of[int(v)]
            for s, eid in zip(srcs, eids):
                s_int = int(s)
                if s_int not in local_of:
                    local_of[s_int] = next_local
                    next_local += 1
                    next_frontier.append(s_int)
                e_src.append(local_of[s_int])
                e_dst.append(dst_local)
                e_ids.append(eid)
        if next_frontier:
            node_list.append(np.asarray(next_frontier, dtype=np.int64))
        frontier = np.asarray(next_frontier, dtype=np.int64)

    nodes = np.concatenate(node_list) if len(node_list) > 1 else seeds
    return (nodes,
            np.asarray(e_src, dtype=np.int32),
            np.asarray(e_dst, dtype=np.int32),
            np.asarray(e_ids, dtype=np.int64))


def get_train_node_idx(ptr: np.ndarray, weights: Sequence[float],
                       rng: np.random.Generator) -> np.ndarray:
    """Weighted per-dataset seed repetition (process_datasets.py:186-198):
    the integer part of a weight repeats every node of its dataset, the
    fractional part adds a random subset.  ``ptr`` are the dataset node
    offsets of the merged graph."""
    total = []
    for idx, (s, e) in enumerate(zip(ptr[:-1], ptr[1:])):
        arr = np.arange(s, e)
        w = weights[idx]
        int_w, mod_w = int(w), w - int(w)
        parts = [np.tile(arr, int_w)]
        n_extra = int(mod_w * arr.size)
        if n_extra > 0:
            parts.append(rng.permutation(arr.size)[:n_extra] + s)
        total.append(np.concatenate(parts) if parts else arr[:0])
    return np.concatenate(total)


class NeighborBatchIterator:
    """Shuffled seed batches -> padded graphs of ids on the host: ``(graph,
    number of seeds, global node ids)`` per batch, the graph an
    :class:`~stemgnn_tpu_torch.core.graph.IndexedGraph` whose features are
    gathered on the device (``core.graph.materialize_graph``).

    Padding buckets: nodes to ``node_pad`` and edges to ``edge_pad`` when
    given, else probed from the seeds.  ``truncations`` counts batches
    clamped at the closure caps (edges dropped), ``escalations`` bucket
    regrowths (no edge dropped)."""

    def __init__(self, csc: CSCGraph, x_ids: np.ndarray,
                 xe_ids: Optional[np.ndarray], seeds: np.ndarray,
                 batch_size: int, fanouts: Sequence[int],
                 rng: np.random.Generator, node_pad: Optional[int] = None,
                 edge_pad: Optional[int] = None, drop_last: bool = False,
                 use_native: bool = True):
        self.csc = csc
        self.x_ids = x_ids
        self.xe_ids = xe_ids
        self.seeds = np.asarray(seeds)
        self.batch_size = batch_size
        self.fanouts = list(fanouts)
        self.rng = rng
        self.drop_last = drop_last
        self.truncations = 0
        self.escalations = 0
        self._native = use_native
        if use_native:
            native_sampler.load()        # raises when it cannot be built
        closure = batch_size
        width = batch_size
        edge_closure = 0
        for f in self.fanouts:
            width = width * max(f, 1)
            closure += width
            edge_closure += width
        worst_n = round_up(min(closure, csc.num_nodes + batch_size), 128)
        # every sampled edge is kept even when its source was seen before,
        # so the edge worst case is the per-hop width sum
        worst_e = round_up(max(edge_closure, 128), 128)
        if node_pad is None and edge_pad is None and len(self.seeds):
            # Empirical buckets: probe chunks are consecutive slices of a
            # permutation (the epoch loop's batching); pads = probe max + a
            # spread-scaled margin, cached on the CSC graph per (batch
            # size, fanouts)
            cache_key = (batch_size, tuple(self.fanouts))
            cache = getattr(csc, "_pad_cache", None)
            if cache is None:
                cache = {}
                csc._pad_cache = cache
            if cache_key in cache:
                node_pad, edge_pad = cache[cache_key]
            else:
                probe_rng = np.random.default_rng(0xC0FFEE)
                perm = probe_rng.permutation(len(self.seeds))
                probe_chunks = [
                    self.seeds[perm[i * batch_size:(i + 1) * batch_size]]
                    for i in range(min(
                        16, max(len(perm) // max(batch_size, 1), 1)))]
                szs = []
                for chunk in probe_chunks:
                    nodes, es, _, _, _ = self._sample(chunk, probe_rng,
                                                      node_cap=worst_n,
                                                      edge_cap=worst_e)
                    szs.append((len(nodes), len(es)))
                arr = np.asarray(szs)

                def bucket(col, cap, floor):
                    mx, mn = int(col.max()), int(col.min())
                    margin = max(6 * (mx - mn), mx // 4, floor)
                    return round_up(min(mx + margin, cap), 128)

                node_pad = bucket(arr[:, 0], worst_n, batch_size // 4 + 8)
                edge_pad = bucket(arr[:, 1], worst_e, 128)
                cache[cache_key] = (node_pad, edge_pad)
            self._cache_ref = (cache, cache_key)
        else:
            self._cache_ref = None
        if node_pad is None:
            node_pad = worst_n
        if edge_pad is None:
            edge_pad = worst_e
        self.node_pad = node_pad
        self.edge_pad = edge_pad
        self._worst_n = worst_n
        self._worst_e = worst_e

    def __iter__(self):
        order = self.rng.permutation(len(self.seeds))
        bs = self.batch_size
        for i in range(0, len(order), bs):
            chunk = self.seeds[order[i: i + bs]]
            if self.drop_last and len(chunk) < bs:
                break
            yield self.make_batch(chunk)

    def __len__(self):
        n, bs = len(self.seeds), self.batch_size
        return n // bs if self.drop_last else (n + bs - 1) // bs

    def _sample(self, seed_chunk: np.ndarray, rng, node_cap: int,
                edge_cap: int):
        """(nodes, e_src, e_dst, e_ids, clamped); ``clamped`` only when a
        cap dropped something."""
        if self._native:
            seed64 = int(rng.integers(0, 2**62))
            nodes, es, ed, eids, clamped = \
                native_sampler.sample_subgraph_native(
                    self.csc, seed_chunk, self.fanouts, seed64,
                    node_cap=node_cap, edge_cap=edge_cap, with_clamped=True)
            if clamped:
                # a node-cap overflow emits edges whose local ids point past
                # the kept node prefix: drop them as the numpy path does
                keep = (es < len(nodes)) & (ed < len(nodes))
                es, ed, eids = es[keep], ed[keep], eids[keep]
            return nodes, es, ed, eids, clamped
        nodes, es, ed, eids = sample_subgraph(self.csc, seed_chunk,
                                              self.fanouts, rng)
        # the native sampler's capping: nodes are BFS-ordered (seeds first),
        # edges hop-ordered, so a prefix keeps the nearest hops
        clamped = len(nodes) > node_cap
        if clamped:
            nodes = nodes[:node_cap]
        keep = (es < len(nodes)) & (ed < len(nodes))
        es, ed, eids = es[keep], ed[keep], eids[keep]
        clamped = clamped or len(es) > edge_cap
        es, ed, eids = es[:edge_cap], ed[:edge_cap], eids[:edge_cap]
        return nodes, es, ed, eids, clamped

    def make_batch(self, seed_chunk: np.ndarray):
        # sampled against the worst-case closure caps: a batch that outgrows
        # its bucket escalates the bucket instead of losing edges; only the
        # closure caps themselves truncate (the reference's per-hop caps,
        # gp/utils/graph.py:32-46)
        nodes, es, ed, eids, clamped = self._sample(seed_chunk, self.rng,
                                                    node_cap=self._worst_n,
                                                    edge_cap=self._worst_e)
        if clamped:
            self.truncations += 1
            global _TRUNC_WARNED
            if not _TRUNC_WARNED:
                _TRUNC_WARNED = True
                print(f"[sampler] batch saturated the worst-case closure "
                      f"cap ({len(nodes)}/{self._worst_n} nodes, "
                      f"{len(es)}/{self._worst_e} edges) — truncating "
                      f"(counted in .truncations; warning printed once)")
        if len(nodes) > self.node_pad or len(es) > self.edge_pad:
            # grow with headroom, shared through the CSC cache
            self.escalations += 1
            if len(nodes) > self.node_pad:
                self.node_pad = round_up(
                    min(len(nodes) + len(nodes) // 8 + 1, self._worst_n),
                    128)
            if len(es) > self.edge_pad:
                self.edge_pad = round_up(
                    min(len(es) + len(es) // 8 + 1, self._worst_e), 128)
            if self._cache_ref is not None:
                cache, key = self._cache_ref
                cache[key] = (self.node_pad, self.edge_pad)
            print(f"[sampler] padding bucket escalated to "
                  f"({self.node_pad} nodes, {self.edge_pad} edges), no "
                  f"dropped edges (count in .escalations)")
        nodes = nodes[: self.node_pad]          # closure-cap clamp only
        keep = (es < len(nodes)) & (ed < len(nodes))
        es, ed, eids = es[keep], ed[keep], eids[keep]
        if len(es) > self.edge_pad:
            es, ed, eids = (es[: self.edge_pad], ed[: self.edge_pad],
                            eids[: self.edge_pad])
        xe = None if self.xe_ids is None else self.xe_ids[eids]
        ig = make_indexed_graph(self.x_ids[nodes], es, ed, xe_ids=xe,
                                node_pad_to=self.node_pad,
                                edge_pad_to=self.edge_pad)
        return ig, len(seed_chunk), nodes
