"""Flash-attention kernel with grouped-query heads (public wrapper in ops.py)."""
from .ops import attention_ref, flash_attention

__all__ = ["flash_attention", "attention_ref"]
