"""Language-model architectures of the port (every family of the
reference).

``registry.build_model`` is the entry point: an ``ArchConfig`` in, an
:class:`~repro_torch.archs.lm.LM` module (or, for the audio family, an
:class:`~repro_torch.archs.encdec.EncDec`) on the card (or the host, when
asked) out.  Attention reaches the hand-written flash-attention kernel
(``kernels/flash_attention``) on the cacheless forward when
``cfg.use_flash`` is set, as the reference does.
"""
