"""Repeat-unit pattern clustering (offline analysis).

Capability-equivalent to the reference advntr/pattern_clustering.py: cluster
a locus's repeat-unit sequences by edit distance, picking the cluster count
at the elbow of the intra-cluster-similarity curve.

Counterpart of advntr_tpu/models/pattern_clustering.py, whose text it keeps
up to ``get_pattern_clusters``.  There sklearn's
``AgglomerativeClustering(metric="precomputed", linkage="complete")`` makes
the clusters; sklearn is not a dependency of this package, so
``_complete_linkage_children`` and ``_hc_cut`` do what that fit does
(sklearn 1.9.0, ``linkage_tree`` and ``_hc_cut``): scipy's complete linkage
over the condensed upper triangle of the distances, then the cut that
splits the largest node first and numbers the clusters in heap order.  The
labels, not just the partition, equal sklearn's.
"""

from __future__ import annotations

import numpy as np

from advntr_tpu_torch.models.msa import needleman_wunsch


def get_sequence_distance(s: str, t: str,
                          high_indel_penalty: bool = False) -> float:
    max_length = max(len(s), len(t))
    if high_indel_penalty:
        # match 1, mismatch -0.5 approximated by the (1,-1,-1,-1) aligner's
        # score; the reference uses globalms(1,-.5,-1,-1)
        return max_length - needleman_wunsch(s, t)[2]
    # globalxx counts matched positions only: identity score
    a, b, _ = needleman_wunsch(s, t)
    matches = sum(1 for x, y in zip(a, b) if x == y and x != "-")
    return max_length - matches


def get_distance_matrix(patterns: list[str]) -> np.ndarray:
    n = len(patterns)
    dist = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            dist[i, j] = get_sequence_distance(patterns[i], patterns[j])
    return dist


def _cluster_similarities(clusters, dist) -> list[float]:
    out = []
    for cluster in clusters:
        sim = sum(dist[i][j] for i in cluster for j in cluster)
        out.append(sim / len(cluster) ** 2)
    return out


def get_elbow_point_index(curve) -> int:
    """Point with max distance from the first-to-last chord."""
    n = len(curve)
    coords = np.vstack((range(n), curve)).T
    first = coords[0]
    line = coords[-1] - coords[0]
    norm = np.sqrt((line ** 2).sum())
    if norm == 0:
        return 0
    line = line / norm
    from_first = coords - first
    proj = (from_first * line).sum(axis=1)
    parallel = np.outer(proj, line)
    dists = np.sqrt(((from_first - parallel) ** 2).sum(axis=1))
    return int(np.argmax(dists))


def get_pattern_clusters(patterns: list[str]) -> list[list[str]]:
    if len(patterns) == 1:
        return [list(patterns)]
    dist = get_distance_matrix(patterns)
    children = _complete_linkage_children(dist)
    distortions = []
    clusterings = []
    for k in range(1, len(patterns) + 1):
        clusters = [[] for _ in range(k)]
        for idx, label in enumerate(_hc_cut(k, children, len(patterns))):
            clusters[label].append(idx)
        sims = _cluster_similarities(clusters, dist)
        distortions.append(sum(sims) / float(len(sims)))
        clusterings.append(clusters)
    distortions.reverse()
    clusterings.reverse()
    best = clusterings[get_elbow_point_index(distortions)]
    return [[patterns[i] for i in cluster] for cluster in best]


def _complete_linkage_children(dist: np.ndarray) -> np.ndarray:
    """The merge tree of complete linkage on a precomputed distance matrix:
    row i merges two nodes into node n + i (sklearn's ``children_``)."""
    from scipy.cluster.hierarchy import linkage
    i, j = np.triu_indices(dist.shape[0], k=1)
    return linkage(dist[i, j], method="complete")[:, :2].astype(int)


def _hc_cut(n_clusters: int, children: np.ndarray,
            n_leaves: int) -> np.ndarray:
    """Cut the merge tree into ``n_clusters``: split the largest node
    first, and label each cluster by its place in the heap of node
    numbers (sklearn's ``_hc_cut``)."""
    import heapq
    nodes = [-(max(children[-1]) + 1)]
    for _ in range(n_clusters - 1):
        these_children = children[-nodes[0] - n_leaves]
        heapq.heappush(nodes, -these_children[0])
        heapq.heappushpop(nodes, -these_children[1])
    label = np.zeros(n_leaves, dtype=np.intp)
    for i, node in enumerate(nodes):
        label[_descendants(-node, children, n_leaves)] = i
    return label


def _descendants(node: int, children: np.ndarray, n_leaves: int) -> list:
    """The leaves under ``node``."""
    stack, leaves = [node], []
    while stack:
        i = stack.pop()
        if i < n_leaves:
            leaves.append(i)
        else:
            stack.extend(children[i - n_leaves])
    return leaves
