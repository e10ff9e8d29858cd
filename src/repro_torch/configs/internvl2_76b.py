"""internvl2-76b — VLM: InternViT frontend STUBBED + InternLM2-like backbone.

[arXiv:2404.16821; unverified] 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256.  The model takes precomputed patch embeddings
(n_patches=256), prepended to the token stream.
"""
from ..archs.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
        n_heads=64, n_kv=8, d_ff=28672, vocab=128256, n_patches=256,
        train_accum=4)


def smoke_config() -> ArchConfig:
    return config().with_(n_layers=2, d_model=128, n_heads=4, n_kv=2,
                          d_head=32, d_ff=256, vocab=512, n_patches=8)
