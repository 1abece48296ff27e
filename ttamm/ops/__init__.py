from .losses import bce_with_logits, category_alignment_loss
from .sampling import sample_eval_candidates, sample_negative_items
from .sparse_adam import (
    SparseAdamState,
    SparseAdamStatePacked,
    init_sparse_adam,
    sparse_adam_update,
)
from .topk import mips_topk, topk_with_mask

__all__ = [
    "SparseAdamState",
    "SparseAdamStatePacked",
    "bce_with_logits",
    "category_alignment_loss",
    "init_sparse_adam",
    "mips_topk",
    "sample_eval_candidates",
    "sample_negative_items",
    "sparse_adam_update",
    "topk_with_mask",
]
