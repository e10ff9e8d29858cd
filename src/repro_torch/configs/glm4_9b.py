"""glm4-9b — dense, RoPE, GQA kv=2.

[hf:THUDM/glm-4-9b] 40L d_model=4096 32H d_ff=13696 vocab=151552.
"""
from ..archs.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="glm4-9b", family="dense", n_layers=40, d_model=4096,
        n_heads=32, n_kv=2, d_ff=13696, vocab=151552)


def smoke_config() -> ArchConfig:
    return config().with_(n_layers=2, d_model=128, n_heads=4, n_kv=1,
                          d_head=32, d_ff=256, vocab=512)
