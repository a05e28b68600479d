"""Node-reordering permutations for gather locality (counterpart of
``stemgnn_tpu/ops/reorder.py``, numpy, equal bit for bit).

Relabelling node ids so that rows referenced together sit together:

  * ``degree_order`` — hot (high-degree) rows first: the most-referenced rows
    concentrate in a small, reused address range.
  * ``rcm_order`` — reverse Cuthill–McKee (BFS from a peripheral low-degree
    node, neighbors visited in degree order): minimizes index bandwidth for
    mesh/community graphs, so each edge chunk touches a compact row range.
  * ``community_order`` — label propagation, then nodes sorted by community
    (communities chained by their mutual edge weight).

Host-side, once per graph; composes with
:func:`stemgnn_tpu_torch.ops.edge_layout.build_edge_layout` by relabelling
the edge list and permuting the feature matrix (:func:`relabel`,
``train.graph_setup.reorder_dataset``).  ``community_order``'s label
propagation (:func:`propagate_labels`) sorts its (node, label) keys by
value and picks each node's label with one reduction, where JAX argsorts
and lexsorts: the labels and the order are the same, in less host time
(``python -m stemgnn_tpu_torch.profile_reorder`` times both).  On the H100 the kernels gather rows at any address, so the relabel feeds the local/stray split
(``build_edge_layout(loc_split=...)``) and the row gathers' cache reuse; the
TPU profile's windowed-gather gate reads it as JAX does.
"""

from __future__ import annotations

import numpy as np


def degree_order(senders, receivers, num_nodes: int) -> np.ndarray:
    """Permutation ``perm`` with ``perm[new_id] = old_id``, highest total
    degree first."""
    deg = np.zeros(num_nodes, np.int64)
    np.add.at(deg, np.asarray(senders, np.int64), 1)
    np.add.at(deg, np.asarray(receivers, np.int64), 1)
    return np.argsort(-deg, kind="stable").astype(np.int64)


def rcm_order(senders, receivers, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill–McKee over the undirected graph.  Returns
    ``perm[new_id] = old_id``; isolated nodes go last."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    # undirected CSR
    u = np.concatenate([s, r])
    v = np.concatenate([r, s])
    deg = np.bincount(u, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    order = np.argsort(u, kind="stable")
    indices = v[order]

    visited = np.zeros(num_nodes, bool)
    out = np.empty(num_nodes, np.int64)
    pos = 0
    # process components from lowest-degree unvisited seed
    seed_order = np.argsort(deg, kind="stable")
    seed_i = 0
    while pos < num_nodes:
        while seed_i < num_nodes and visited[seed_order[seed_i]]:
            seed_i += 1
        if seed_i >= num_nodes:
            break
        seed = seed_order[seed_i]
        visited[seed] = True
        out[pos] = seed
        head, pos = pos, pos + 1
        while head < pos:
            node = out[head]
            head += 1
            nbrs = indices[indptr[node]: indptr[node + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = np.unique(nbrs)          # dedupe multi-edges
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                out[pos: pos + nbrs.size] = nbrs
                pos += nbrs.size
    return out[::-1].copy()                     # the "reverse" in RCM


def relabel(perm: np.ndarray, senders, receivers, node_arrays=()):
    """Apply ``perm`` (new->old): returns (senders', receivers',
    [arr[perm] for arr in node_arrays]).  Edge (j, i) keeps its slot; only
    ids change, so edge-aligned arrays (types, masks) are untouched."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    s2 = inv[np.asarray(senders, np.int64)]
    r2 = inv[np.asarray(receivers, np.int64)]
    return s2, r2, [np.asarray(a)[perm] for a in node_arrays]


def propagate_labels(senders, receivers, num_nodes: int,
                     iters: int = 15) -> np.ndarray:
    """The label propagation of :func:`community_order`: each round every
    node takes its neighbours' most frequent label (ties -> the smallest),
    all at once, for ``iters`` rounds or until nothing changes.  Returns
    [num_nodes] int64 labels."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    u = np.concatenate([s, r])
    v = np.concatenate([r, s])
    lab = np.arange(num_nodes, dtype=np.int64)
    width = np.int64(num_nodes + 1)
    base = u * width
    for _ in range(iters):
        # the (node, neighbour label) runs: only their keys and lengths
        # count, so the keys are sorted by value (JAX's stable argsort of
        # the same keys gives the same runs)
        ks = np.sort(base + lab[v])
        boundary = np.ones(len(ks), bool)
        boundary[1:] = ks[1:] != ks[:-1]
        starts = np.nonzero(boundary)[0]
        counts = np.diff(np.append(starts, len(ks)))
        run_node = ks[starts] // width
        run_label = ks[starts] % width
        # per node: the label with max count (ties -> smallest label).
        # The runs come sorted by (node, label), so a node's first run of
        # its largest count is the one (what JAX's lexsort by node, -count,
        # label puts first)
        node_first = np.ones(len(run_node), bool)
        node_first[1:] = run_node[1:] != run_node[:-1]
        group = np.nonzero(node_first)[0]
        top = np.maximum.reduceat(counts, group)
        best = np.nonzero(counts == np.repeat(top, np.diff(
            np.append(group, len(counts)))))[0]
        keep = np.ones(len(best), bool)
        keep[1:] = run_node[best[1:]] != run_node[best[:-1]]
        best = best[keep]
        new_lab = lab.copy()
        new_lab[run_node[best]] = run_label[best]
        if np.array_equal(new_lab, lab):
            break
        lab = new_lab
    return lab


def community_order(senders, receivers, num_nodes: int, iters: int = 15,
                    refine_rcm: bool = True) -> np.ndarray:
    """Community ordering via synchronous majority label propagation, then
    nodes sorted by (community label, node id).  Recovers block/community
    structure that RCM cannot (a few percent of random long-range edges
    pull RCM's BFS across communities, BASELINE.md round-3 measurements);
    intra-community edges then fall inside the windowed kernels' reach.
    ``refine_rcm`` additionally RCM-orders the community-graph itself so
    adjacent communities sit near each other (helps when communities are
    smaller than the window).  Returns ``perm[new_id] = old_id``."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    lab = propagate_labels(s, r, num_nodes, iters)
    if refine_rcm:
        # Place communities by a greedy max-affinity chain over the
        # WEIGHTED quotient graph: LPA fragments one true community into a
        # few labels whose mutual edge weight dwarfs the random
        # inter-community noise, so chaining by heaviest connection to the
        # last-placed community reassembles fragments adjacently.  (RCM on
        # the quotient fails here: the noise edges make it near-complete
        # unweighted.)  Dense [C, C] counts; skipped for huge C.
        uniq, lab_c = np.unique(lab, return_inverse=True)
        C = len(uniq)
        cs, cr = lab_c[s], lab_c[r]
        inter = cs != cr
        if inter.any() and 1 < C <= 8192:
            w = np.zeros((C, C), np.int64)
            np.add.at(w, (cs[inter], cr[inter]), 1)
            w += w.T
            placed = np.zeros(C, bool)
            chain = np.empty(C, np.int64)
            cur = int(np.argmax(w.sum(1)))
            for i in range(C):
                placed[cur] = True
                chain[i] = cur
                nxt = np.where(placed, -1, w[cur])
                cur = int(np.argmax(nxt))
                if nxt[cur] <= 0:
                    rem = np.nonzero(~placed)[0]
                    if len(rem) == 0:
                        break
                    cur = int(rem[np.argmax(w[np.ix_(chain[:i + 1],
                                                     rem)].sum(0))]) \
                        if i + 1 < C else int(rem[0])
            crank = np.empty(C, np.int64)
            crank[chain] = np.arange(C)
            lab = crank[lab_c]
    return np.lexsort((np.arange(num_nodes), lab)).astype(np.int64)
