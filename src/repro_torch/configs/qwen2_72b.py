"""qwen2-72b — dense, GQA kv=8, QKV bias.

[arXiv:2407.10671; hf] 80L d_model=8192 64H d_ff=29568 vocab=152064.
"""
from ..archs.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-72b", family="dense", n_layers=80, d_model=8192,
        n_heads=64, n_kv=8, d_ff=29568, vocab=152064, qkv_bias=True,
        train_accum=4)


def smoke_config() -> ArchConfig:
    return config().with_(n_layers=2, d_model=128, n_heads=4, n_kv=2,
                          d_head=32, d_ff=256, vocab=512)
