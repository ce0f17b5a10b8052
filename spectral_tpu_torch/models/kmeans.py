"""sklearn-exact KMeans (numpy, host-side) for hmmlearn-parity HMM init.

The reference's detector IS hmmlearn (PlotEngine.py:9,20,392), and hmmlearn
initializes GaussianHMM means with ``sklearn.cluster.KMeans(n_clusters=K,
random_state=seed, n_init=10)``. Same data must land in the same EM basin as
the reference, so this module reproduces sklearn's KMeans *exactly* — same
k-means++ RNG consumption, same Lloyd updates, same empty-cluster relocation,
same tolerance and best-run selection — rather than a merely-similar k-means.
Equality against the installed sklearn is asserted in
tests/test_hmmlearn_parity.py (sklearn stays a test-only oracle, like scipy).

Algorithm sources (sklearn 1.9, BSD-3): _kmeans_plusplus and the fit loop in
sklearn/cluster/_kmeans.py; lloyd_iter_chunked_dense and
_relocate_empty_clusters_dense in sklearn/cluster/_k_means_{lloyd,common}.pyx.
This is an independent numpy re-implementation of those semantics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["kmeans_fit"]


def _kmeans_plusplus(X: np.ndarray, n_clusters: int,
                     x_squared_norms: np.ndarray,
                     rng: np.random.RandomState) -> np.ndarray:
    """k-means++ seeding with sklearn's exact RNG consumption order."""
    n_samples = X.shape[0]
    n_local_trials = 2 + int(np.log(n_clusters))
    w = np.ones(n_samples) / n_samples   # uniform sample_weight, normalized
    center_id = rng.choice(n_samples, p=w)
    centers = np.empty((n_clusters, X.shape[1]), dtype=X.dtype)
    centers[0] = X[center_id]

    def sq_dists(C):
        # sklearn _euclidean_distances(squared=True): ||c||^2 - 2 c.x + ||x||^2,
        # clipped at 0
        d = (np.sum(C * C, axis=1)[:, None] - 2.0 * (C @ X.T)
             + x_squared_norms[None, :])
        return np.maximum(d, 0.0)

    closest_dist_sq = sq_dists(centers[0:1])[0]
    sample_weight = np.ones(n_samples, dtype=X.dtype)
    current_pot = closest_dist_sq @ sample_weight
    for c in range(1, n_clusters):
        rand_vals = rng.uniform(size=n_local_trials) * current_pot
        candidate_ids = np.searchsorted(
            np.cumsum(sample_weight * closest_dist_sq), rand_vals)
        np.clip(candidate_ids, None, closest_dist_sq.size - 1,
                out=candidate_ids)
        distance_to_candidates = sq_dists(X[candidate_ids])
        np.minimum(closest_dist_sq, distance_to_candidates,
                   out=distance_to_candidates)
        candidates_pot = distance_to_candidates @ sample_weight
        best = int(np.argmin(candidates_pot))
        current_pot = candidates_pot[best]
        closest_dist_sq = distance_to_candidates[best]
        centers[c] = X[candidate_ids[best]]
    return centers


def _row_sq_dists(diff: np.ndarray) -> np.ndarray:
    """Row-wise squared distances in sklearn's _euclidean_dense_dense
    accumulation ORDER, vectorized over rows: 4-wide feature blocks are
    summed left-associatively and then added to the accumulator, the
    remainder singly. numpy's .sum(axis=1) switches to 8-accumulator
    unrolling at >= 8 features and diverges in the last ulp — enough to
    flip the strict best-run selection on inertia ties."""
    d = diff.shape[1]
    sq = diff * diff
    acc = np.zeros(diff.shape[0], dtype=diff.dtype)
    n4 = (d // 4) * 4
    for j in range(0, n4, 4):
        acc += ((sq[:, j] + sq[:, j + 1]) + sq[:, j + 2]) + sq[:, j + 3]
    for j in range(n4, d):
        acc += sq[:, j]
    return acc


def _lloyd_iter(X: np.ndarray, centers_old: np.ndarray,
                update_centers: bool = True):
    """One Lloyd iteration (lloyd_iter_chunked_dense semantics, weight=1).

    Assignment uses the half-||c||^2 - x.c form sklearn's kernel uses, so tie
    behavior matches (argmin scans with strict <, lowest index wins).
    Returns (labels, centers_new, weight_in_clusters).
    """
    half_norms = 0.5 * np.sum(centers_old * centers_old, axis=1)
    scores = half_norms[None, :] - X @ centers_old.T
    labels = np.argmin(scores, axis=1).astype(np.int32)
    if not update_centers:
        return labels, None, None
    k = centers_old.shape[0]
    weight = np.bincount(labels, minlength=k).astype(X.dtype)
    centers_new = np.zeros_like(centers_old)
    np.add.at(centers_new, labels, X)

    # _relocate_empty_clusters_dense: move the farthest-from-center points
    # into empty clusters (one point per empty cluster, farthest first)
    empty = np.where(weight == 0)[0]
    if empty.size:
        distances = _row_sq_dists(X - centers_old[labels])
        if np.max(distances) > 0:
            far = np.argpartition(distances, -empty.size)[:-empty.size - 1:-1]
            for idx in range(empty.size):
                far_idx = far[idx]
                old = labels[far_idx]
                centers_new[old] -= X[far_idx]
                centers_new[empty[idx]] = X[far_idx]
                weight[empty[idx]] = 1.0
                weight[old] -= 1.0

    nz = weight > 0
    # sklearn's _average_centers multiplies by the RECIPROCAL
    # (alpha = 1/weight; centers *= alpha), and x*(1/w) differs from x/w
    # in the last ulp — enough to flip labels on near-duplicate data, so
    # the asserted bit-for-bit parity requires the same form
    centers_new[nz] *= (1.0 / weight[nz])[:, None]
    return labels, centers_new, weight


def _kmeans_single_lloyd(X: np.ndarray, centers_init: np.ndarray,
                         max_iter: int, tol: float):
    centers = centers_init
    labels_old = np.full(X.shape[0], -1, dtype=np.int32)
    strict = False
    labels = labels_old
    for _ in range(max_iter):
        labels, centers_new, _w = _lloyd_iter(X, centers)
        # _center_shift: per-cluster _euclidean_dense_dense(squared=False)
        center_shift = np.sqrt(_row_sq_dists(centers_new - centers))
        centers = centers_new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (center_shift ** 2).sum() <= tol:
            break
        labels_old = labels.copy()
    if not strict:
        labels, _, _ = _lloyd_iter(X, centers, update_centers=False)
    # sklearn's _inertia_dense accumulates SEQUENTIALLY per sample (a C
    # loop); numpy .sum() uses pairwise summation, and the 1-ulp
    # difference flips the strict `inertia < best_inertia` run selection
    # on ties — so accumulate per-sample sums sequentially here too
    per_sample = _row_sq_dists(X - centers[labels])
    inertia = 0.0
    for v in per_sample:
        inertia += v
    return labels, float(inertia), centers


def _is_same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """True when the partitions are identical up to label permutation."""
    mapping = np.full(k, -1, dtype=np.int64)
    for la, lb in zip(a, b):
        if mapping[la] == -1:
            mapping[la] = lb
        elif mapping[la] != lb:
            return False
    return True


def kmeans_fit(X, n_clusters: int, seed: Optional[int] = 42,
               n_init: int = 10, max_iter: int = 300,
               tol: float = 1e-4) -> Tuple[np.ndarray, np.ndarray, float]:
    """sklearn.cluster.KMeans(n_clusters, random_state=seed, n_init).fit(X)
    — the exact call hmmlearn makes to initialize GaussianHMM means.

    Returns (cluster_centers_, labels_, inertia_)."""
    X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
    rng = np.random.RandomState(seed)
    # sklearn calls _tolerance(X, tol) in fit() BEFORE _fit centers the
    # data (X -= X_mean), so the tolerance must come from the UNCENTERED
    # variances — var(Xc) differs in the last ulps and can move the Lloyd
    # loop's stopping iteration relative to the oracle
    tol_abs = float(np.mean(np.var(X, axis=0)) * tol)
    x_mean = X.mean(axis=0)
    Xc = X - x_mean
    x_squared_norms = np.sum(Xc * Xc, axis=1)

    best_inertia, best_labels, best_centers = None, None, None
    for _ in range(n_init):
        centers_init = _kmeans_plusplus(Xc, n_clusters, x_squared_norms, rng)
        labels, inertia, centers = _kmeans_single_lloyd(
            Xc, centers_init, max_iter, tol_abs)
        if best_inertia is None or (
                inertia < best_inertia
                and not _is_same_clustering(labels, best_labels, n_clusters)):
            best_inertia, best_labels, best_centers = inertia, labels, centers
    return best_centers + x_mean, best_labels, best_inertia
