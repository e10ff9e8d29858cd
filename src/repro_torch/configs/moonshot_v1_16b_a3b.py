"""moonshot-v1-16b-a3b — MoE 64 experts top-6 (kimi/moonlight), MHA kv=16.

[hf:moonshotai/Moonlight-16B-A3B] 48L d_model=2048 16H d_ff=1408
vocab=163840.
"""
from ..archs.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=16, n_kv=16, d_ff=1408, vocab=163840,
        n_experts=64, top_k=6,
        train_accum=4)


def smoke_config() -> ArchConfig:
    return config().with_(n_layers=2, d_model=128, n_heads=4, n_kv=4,
                          d_head=32, d_ff=128, vocab=512, n_experts=8,
                          top_k=2)
