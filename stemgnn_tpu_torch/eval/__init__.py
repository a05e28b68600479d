"""Robustness evaluation helpers (counterpart of ``stemgnn_tpu/eval``):
the degree / homophily / alignment buckets and stratified splits
(:mod:`.buckets`), the feature and edge perturbations (:mod:`.perturb`) and
the train-and-evaluate runner of the scripts (:mod:`.runner`)."""

from stemgnn_tpu_torch.eval.buckets import (  # noqa: F401
    compute_alignment_buckets,
    compute_degree_buckets,
    compute_homophily_buckets,
    stratified_split,
)
from stemgnn_tpu_torch.eval.perturb import (  # noqa: F401
    apply_missing_features,
    apply_random_edge_drops,
)
