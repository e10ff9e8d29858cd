"""dbrx-132b — MoE 16 experts top-4 (fine-grained), GQA kv=8.

[hf:databricks/dbrx-base; unverified] 40L d_model=6144 48H d_ff=10752
vocab=100352.
"""
from ..archs.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
        n_heads=48, n_kv=8, d_ff=10752, vocab=100352,
        n_experts=16, top_k=4,
        train_accum=4)


def smoke_config() -> ArchConfig:
    return config().with_(n_layers=2, d_model=128, n_heads=4, n_kv=2,
                          d_head=32, d_ff=128, vocab=512, n_experts=4,
                          top_k=2)
