"""Greedy peak clustering and anchor detection (controller-side).

The port's copy of ``hicpeaks_tpu/core/clustering.py``, unchanged.

Semantic re-implementation of the reference post-processing
(``find_anchors``/``_cluster_core``/``local_clustering``,
hicpeaks/callers.py:593-727).  Peak candidate sets are small (1e2-1e4),
so this intentionally stays on the host in NumPy/SciPy — per SURVEY §2.11
it is not worth TPU time.  Behavioural quirks of the reference that affect
output and are deliberately preserved:

* the cluster seed participates twice in every centroid mean (the seed is
  both the initial member and re-collected from its own DBSCAN cluster);
* growth stops when an iteration strands the same number of far points as
  the previous one, *without* re-centering on the final collection;
* anchor intervals merge only with the first previously-claimed bin they
  overlap, inheriting that anchor's summit;
* anchor pairs are visited in Python-set iteration order (the reference
  iterates ``set`` objects of int tuples; we do the same so tie-breaking
  matches CPython's behaviour).
"""
from __future__ import annotations

import numpy as np
from scipy.signal import find_peaks, peak_widths
from scipy.spatial import cKDTree


def find_anchors(pos, min_count=3, min_dis=20000, wlen=200000, res=10000):
    """Detect 1-D marginal anchors: Counter histogram -> scipy find_peaks
    (height=min_count, distance=min_dis) -> full-prominence peak widths,
    merging overlapping intervals under the highest summit.
    Returns a set of (summit_bin, left_bin, right_bin)."""
    min_dis = max(min_dis // res, 1)
    wlen = min(wlen // res, 10)

    pos = np.asarray(pos, dtype=np.int64)
    base = int(pos.min()) - 1                       # extend one bin each side
    # Dense signal over [min-1, max+1], same range as the reference's
    # refidx list-comp (callers.py:602-603); scipy find_peaks/peak_widths
    # require the dense form, and the range is bounded by chromosome bins
    # (<= ~25K at 10Kb), so this O(range) allocation matches the reference
    # while replacing its per-index Counter lookups with one bincount.
    signal = np.bincount(pos - base, minlength=int(pos.max()) - base + 2).astype(float)

    summits = find_peaks(signal, height=min_count, distance=min_dis)[0]
    order = sorted(((signal[i], i) for i in summits), reverse=True)

    anchors = set()
    claimed = {}
    for _, i in order:
        lips, rips = peak_widths(signal, [i], rel_height=1, wlen=wlen)[2:4]
        lb = base + int(np.round(lips[0]))
        rb = base + int(np.round(rips[0]))
        summit = base + i
        if not anchors:
            merged = (summit, lb, rb)
        else:
            for b in range(lb, rb + 1):
                if b in claimed:
                    prev = claimed[b]
                    merged = (prev[0], min(lb, prev[1]), max(rb, prev[2]))
                    anchors.discard(prev)
                    break
            else:
                merged = (summit, lb, rb)
        anchors.add(merged)
        for b in range(merged[1], merged[2] + 1):
            claimed[b] = merged
    return anchors


def _eps_graph_labels(pts: np.ndarray, eps: float) -> np.ndarray:
    """Cluster labels equivalent to DBSCAN(eps, min_samples=2): with
    min_samples=2 every point with a neighbour within ``eps`` is core, so
    clusters are exactly the connected components of the eps-ball graph and
    isolated points are noise (-1)."""
    n = len(pts)
    labels = np.full(n, -1, dtype=np.int64)
    tree = cKDTree(pts)
    pairs = tree.query_pairs(eps, output_type='ndarray')
    if len(pairs) == 0:
        return labels
    parent = np.arange(n)

    def root(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in pairs:
        ra, rb = root(a), root(b)
        if ra != rb:
            parent[rb] = ra
    isolated = np.ones(n, dtype=bool)
    isolated[pairs.ravel()] = False
    next_label = 0
    seen = {}
    for k in range(n):
        if isolated[k]:
            continue
        r = root(k)
        if r not in seen:
            seen[r] = next_label
            next_label += 1
        labels[k] = seen[r]
    return labels


def _grow_clusters(sort_list, r, visited, final_list):
    """Greedy centroid-radius growth seeded at the strongest ungrabbed pixel
    of each eps-graph cluster (reference `_cluster_core`, callers.py:636-678)."""
    if len(sort_list) < 2:
        return
    pts = np.asarray([p for _, p in sort_list])
    labels = _eps_graph_labels(pts, eps=r)
    grabbed_pool = set()
    for k, (_, seed) in enumerate(sort_list):
        if seed in grabbed_pool or labels[k] == -1:
            continue
        members = pts[labels == labels[k]]
        cen = seed
        rad = r
        collected = [seed]
        prev_stranded = -1
        remaining = members
        while len(remaining):
            stranded = []
            for q in remaining:
                tq = (int(q[0]), int(q[1]))
                if tq in grabbed_pool:
                    continue
                if np.hypot(q[0] - cen[0], q[1] - cen[1]) <= rad:
                    collected.append(tq)
                else:
                    stranded.append(tq)
            if len(stranded) == prev_stranded:
                break
            prev_stranded = len(stranded)
            arr = np.asarray(collected)
            cen = tuple(np.round(arr.mean(axis=0)).astype(int))
            rad = int(np.round(max(
                np.hypot(q[0] - cen[0], q[1] - cen[1]) for q in collected))) + r
            remaining = np.asarray(stranded)
        grabbed_pool.update(collected)
        final_list.append((seed, cen, rad))
    visited.update(grabbed_pool)


def local_clustering(Donuts, LL, res, onlysummit=False, min_count=3, r=20000, sumq=1):
    """Cluster significant pixels into loops (reference callers.py:680-727).

    ``Donuts`` maps (x_bin, y_bin) -> stats tuple whose first element is the
    clustering sort key and last element the q-value; ``LL`` is the
    lower-left-background analogue (None for the bhfdr caller).
    Returns [(seed_pixel, centroid_pixel, radius_bins)].
    """
    final_list = []
    keys = list(Donuts)
    if not keys:
        return final_list
    x = np.asarray([k[0] for k in keys])
    y = np.asarray([k[1] for k in keys])

    x_anchors = find_anchors(x, min_count=min_count, min_dis=r, res=res)
    y_anchors = find_anchors(y, min_count=min_count, min_dis=r, res=res)
    r = max(r // res, 1)
    visited = set()
    lookup = set(zip(x.tolist(), y.tolist()))
    for x_a in x_anchors:
        for y_a in y_anchors:
            sort_list = []
            for i in range(x_a[1], x_a[2] + 1):
                for j in range(y_a[1], y_a[2] + 1):
                    if (i, j) in lookup:
                        sort_list.append((Donuts[(i, j)][0], (i, j)))
            sort_list.sort(reverse=True)
            _grow_clusters(sort_list, r, visited, final_list)

    leftovers = [(Donuts[(i, j)][0], (i, j))
                 for i, j in zip(x.tolist(), y.tolist()) if (i, j) not in visited]
    leftovers.sort(reverse=True)
    _grow_clusters(leftovers, r, visited, final_list)

    x_summits = set(a[0] for a in x_anchors)
    y_summits = set(a[0] for a in y_anchors)
    for i, j in zip(x.tolist(), y.tolist()):
        if (i, j) in visited:
            continue
        if LL is not None:
            qpass = Donuts[(i, j)][-1] + LL[(i, j)][-1] <= sumq
        else:
            qpass = Donuts[(i, j)][-1] <= sumq / 2
        if qpass and ((not onlysummit) or (i in x_summits) or (j in y_summits)):
            final_list.append(((i, j), (i, j), 0))
    return final_list
