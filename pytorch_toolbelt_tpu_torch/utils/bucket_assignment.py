"""Cost-balanced bucket assignment for splitting work across workers
(counterpart of ``pytorch_toolbelt_tpu/utils/bucket_assignment.py``; the
same numpy code, kept here so that the port imports nothing of the JAX
package)."""

import numpy as np

__all__ = [
    "naive_bucket_assignment",
    "random_bucket_assignment",
    "filler_bucket_assignment",
    "compute_bucket_imbalance_score",
]


def naive_bucket_assignment(costs: np.ndarray, num_buckets: int) -> np.ndarray:
    """Sorted round-robin."""
    return np.argsort(costs) % num_buckets


def compute_bucket_imbalance_score(costs: np.ndarray, assignment: np.ndarray) -> float:
    """Std of per-bucket cost sums; lower is better."""
    buckets = np.unique(assignment)
    return float(np.std([np.sum(costs[assignment == b]) for b in buckets]))


def random_bucket_assignment(
    costs: np.ndarray, num_buckets: int, max_iterations: int, rng: np.random.RandomState = None
) -> np.ndarray:
    """Random-permutation search starting from the naive assignment."""
    if rng is None:
        rng = np.random
    best = naive_bucket_assignment(costs, num_buckets)
    best_cost = compute_bucket_imbalance_score(costs, best)
    for _ in range(max_iterations):
        candidate = rng.permutation(best)
        cost = compute_bucket_imbalance_score(costs, candidate)
        if cost < best_cost:
            best, best_cost = candidate, cost
    return best


def filler_bucket_assignment(costs: np.ndarray, num_buckets: int) -> np.ndarray:
    """Greedy: largest item to the least-loaded bucket."""
    order = np.argsort(-costs)
    bucket_cost = np.zeros(num_buckets)
    assignment = np.zeros_like(costs, dtype=int)
    for idx in order:
        target = int(np.argmin(bucket_cost))
        assignment[idx] = target
        bucket_cost[target] += costs[idx]
    return assignment
