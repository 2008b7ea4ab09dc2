from .bucket_assignment import (
    compute_bucket_imbalance_score,
    filler_bucket_assignment,
    naive_bucket_assignment,
    random_bucket_assignment,
)

__all__ = [
    "compute_bucket_imbalance_score",
    "filler_bucket_assignment",
    "naive_bucket_assignment",
    "random_bucket_assignment",
]
