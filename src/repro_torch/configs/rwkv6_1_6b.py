"""rwkv6-1.6b — Finch: attention-free, data-dependent decay linear attention.

[arXiv:2404.05892; unverified] 24L d_model=2048 d_ff=7168 vocab=65536.
O(1)-state decode → runs the long_500k shape natively.  Carried over
field for field from ``src/repro/configs/rwkv6_1_6b.py:9–18``.
"""
from ..archs.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
        n_heads=32, n_kv=32, d_ff=7168, vocab=65536,
        rwkv_head_dim=64, supports_long=True)


def smoke_config() -> ArchConfig:
    return config().with_(n_layers=2, d_model=128, n_heads=2, n_kv=2,
                          d_ff=256, vocab=512, rwkv_head_dim=64)
