"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536.  Attention layers get a sliding window for the long_500k shape
(sub-quadratic requirement); Mamba carries the unbounded context.  Carried
over field for field from ``src/repro/configs/jamba_1_5_large_398b.py:10–25``.
"""
from ..archs.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b", family="hybrid", n_layers=72,
        d_model=8192, n_heads=64, n_kv=8, d_ff=24576, vocab=65536,
        n_experts=16, top_k=2, attn_every=8, moe_every=2,
        d_state=16, d_conv=4, expand=2,
        moment_dtype="bfloat16",     # 398B: f32 moments would not fit HBM
        supports_long=True, window=4096,
        train_accum=4)


def smoke_config() -> ArchConfig:
    return config().with_(n_layers=8, attn_every=4, d_model=128, n_heads=4,
                          n_kv=2, d_head=32, d_ff=128, vocab=512,
                          n_experts=4, top_k=2, window=0,
                          moment_dtype="float32")
