"""deepseek-coder-33b — dense, GQA kv=8, llama-arch.

[arXiv:2401.14196; hf] 62L d_model=7168 56H d_ff=19200 vocab=32256.
"""
from ..archs.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-coder-33b", family="dense", n_layers=62, d_model=7168,
        n_heads=56, n_kv=8, d_ff=19200, vocab=32256,
        train_accum=4)


def smoke_config() -> ArchConfig:
    return config().with_(n_layers=2, d_model=128, n_heads=4, n_kv=2,
                          d_head=32, d_ff=256, vocab=512)
