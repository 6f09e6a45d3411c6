"""Serving tier: continuous batching + shape-bucket registry + paged KV.

The decode-side data path is a *paged* KV cache declared as an OpDef
(``kv_block_gather``) so the planner prices it like any other opaque op;
the control path is a slot-based scheduler that admits prompts through
bucketed prefill programs resolved via the canonical plan cache.
"""
from repro_torch.serving.buckets import BucketEntry, BucketRegistry, bucket_len, pad_free
from repro_torch.serving.engine import Request, ServeMetrics, ServingEngine
from repro_torch.serving.paged_kv import BlockAllocator, make_admit_fn

__all__ = [
    "BlockAllocator", "BucketEntry", "BucketRegistry", "Request",
    "ServeMetrics", "ServingEngine", "bucket_len", "make_admit_fn",
    "pad_free",
]
