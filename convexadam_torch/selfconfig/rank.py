"""Official-style statistical ranking (the L2R evaluation scheme).

Counterpart of ``convexadam_tpu/selfconfig/rank.py``, numpy and scipy only.
Reference: self_configuring/l2r3.py:262-361 — pairwise Wilcoxon rank-sum
"significantly better" scores, tie-averaged rank scaling, 50 noise-perturbed
repeats per metric, and a geometric-mean aggregate that (bug-compatibly)
double-weights the first similarity metric
(``(r0^2 * r1 * r2 * r3)^(1/4)``, l2r3.py:358).
"""

from __future__ import annotations

import numpy as np
import scipy.special
import scipy.stats


def scores_better(task_metric: np.ndarray, p_threshold: float = 0.05) -> np.ndarray:
    """For each candidate j, the number of candidates that beat j with
    statistical significance (Wilcoxon rank-sum over per-case values,
    l2r3.py:262-271) — SMALLER is better.  ``task_metric`` is (N, cases),
    higher values of the metric are better.

    All N x N tests at once: ``scipy.stats.ranksums``' statistic and
    two-sided p-value, computed as it computes them, over each pair's
    concatenated cases (the reference loops over N^2 calls, 11664 at the
    task driver's 108 variants, and the ranking makes 200 such scorings).
    """
    m = np.asarray(task_metric, np.float64)
    n, c = m.shape
    both = np.concatenate(
        [np.broadcast_to(m[:, None, :], (n, n, c)), np.broadcast_to(m[None, :, :], (n, n, c))],
        axis=-1,
    )
    ranked = scipy.stats.rankdata(both, axis=-1)
    s = np.sum(ranked[..., :c], axis=-1)
    expected = c * (c + c + 1) / 2.0
    z = (s - expected) / np.sqrt(c * c * (c + c + 1) / 12.0)
    p = 2 * scipy.special.ndtr(-np.abs(z))
    # better[i, j]: candidate i beats candidate j
    return ((z > 0) & (p < p_threshold)).sum(0).astype(np.float64)


def rankscore_avgtie(scores_int: np.ndarray) -> np.ndarray:
    """Map non-negative integer scores to [0.1, 1] rank scores, averaging
    ties (semantics of l2r3.py:274-292).

    Each candidate's provisional score is a linear ramp value at its
    ascending-sort position; candidates with equal integer scores then share
    the mean ramp value of their group.  Equal scores occupy a contiguous
    run of sort positions, so the group mean does not depend on how the sort
    breaks ties: one bincount average."""
    scores_int = np.asarray(scores_int, np.int64)
    n = len(scores_int)
    ramp = np.empty(n)
    ramp[np.argsort(scores_int)] = np.linspace(0.1, 1, n)
    group_sum = np.bincount(scores_int, weights=ramp)
    group_size = np.bincount(scores_int)
    group_mean = group_sum / np.maximum(group_size, 1e-6)
    return group_mean[scores_int]


def noisy_metric_rank(
    per_case: np.ndarray,
    higher_is_better: bool,
    repeats: int = 50,
    noise: float = 0.1,
    rng: "np.random.Generator | None" = None,
) -> np.ndarray:
    """Average tie-averaged rank over ``repeats`` noise-perturbed Wilcoxon
    scorings (l2r3.py:308-341).  ``per_case`` is (N, cases)."""
    if rng is None:
        rng = np.random.default_rng(0)
    n = per_case.shape[0]
    sign = 1.0 if higher_is_better else -1.0
    out = np.zeros(n)
    for _ in range(repeats):
        subset = per_case + noise * rng.standard_normal(per_case.shape)
        scores = scores_better(sign * subset)
        # rank -scores: fewer candidates-better-than-you → higher rank score
        # (the reference feeds negative ints and relies on numpy wraparound
        # indexing, l2r3.py:283-290 — a constant shift is equivalent)
        neg = -scores.astype(np.int64)
        out += rankscore_avgtie(neg - neg.min())
    return out / repeats


def aggregate_ranks(rank_columns: "list[np.ndarray]") -> np.ndarray:
    """Geometric-mean aggregate that double-weights the first metric:
    ``(r0 * prod(r))^(1/len(r))`` — exactly l2r3.py:354-361
    (``(r0^2 r1 r2 r3)^(1/4)`` for four metrics)."""
    r = np.stack(rank_columns, axis=1)
    k = r.shape[1]
    return np.power(r[:, 0] * np.prod(r, axis=1), 1.0 / k)
