"""whisper-base — encoder–decoder; conv audio frontend STUBBED.

[arXiv:2212.04356; unverified] 6L(enc)+6L(dec) d_model=512 8H d_ff=2048
vocab=51865.  The model takes precomputed 1500-frame embeddings in place
of the audio frontend.  The reference's assigned decode/prefill sequence
lengths exceed the real model's 448-token decoder cap; they are honoured
as stress shapes.
"""
from ..archs.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-base", family="audio", n_layers=6, d_model=512,
        n_heads=8, n_kv=8, d_ff=2048, vocab=51865,
        enc_layers=6, enc_seq=1500, cross_attention=True,
        decoder_only=False)


def smoke_config() -> ArchConfig:
    return config().with_(n_layers=2, enc_layers=2, d_model=64, n_heads=2,
                          n_kv=2, d_ff=128, vocab=512, enc_seq=16)
