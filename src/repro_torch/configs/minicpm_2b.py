"""minicpm-2b — dense, MHA (kv=36), WSD schedule, tied embeddings.

[arXiv:2404.06395; hf] 40L d_model=2304 36H d_ff=5760 vocab=122753.
"""
from ..archs.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
        n_heads=36, n_kv=36, d_ff=5760, vocab=122753,
        tie_embeddings=True,
        train_accum=4)


def smoke_config() -> ArchConfig:
    return config().with_(n_layers=2, d_model=96, n_heads=4, n_kv=4,
                          d_head=24, d_ff=192, vocab=512)
