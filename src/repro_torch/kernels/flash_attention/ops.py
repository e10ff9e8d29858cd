"""Public wrapper for the CUDA flash-attention kernel: (B, H, S, D) with GQA.

On a CUDA tensor :func:`flash_attention` launches the hand-written kernel
(``csrc/flash_attention.cu``, built at first use) on the current stream
and raises if the build or the launch fails.  On a CPU tensor it runs the
plain PyTorch version (``ref.py``), because the host has no kernel to
launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .._build import load
from .ref import attention_ref

__all__ = ["flash_attention", "attention_ref", "LAUNCHES", "SOURCES"]

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)
MAX_D = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Kernel launches made by this process (CUDA tensors only).
LAUNCHES = 0


@functools.cache
def _launch_fn():
    """The kernel's C launch function, built and loaded once per process."""
    fn = load("flash_attention", SOURCES).flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """Flash attention with grouped-query heads.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), Hq % Hkv == 0, one dtype
    (float32, bfloat16 or float16).  Returns (B, Hq, Sq, D) in q's dtype.
    The heads are collapsed to (B·H, S, D) as in the reference, and query
    head b reads KV head b // (Hq / Hkv).  Inputs that are not contiguous
    (q after RoPE and the head transpose) are copied to contiguous memory
    before the launch; the kernel takes no strides.

    With ``causal``, query t sees keys ≤ t + Skv − Sq.  Causal with
    Sq > Skv raises: then the first rows see no key at all, and the
    reference kernel's answer for them depends on its tile size (it masks
    with a finite −1e30, its plain oracle with −inf), so there is no one
    answer to hold the port to.  No language-model path calls the kernel
    with Sq ≠ Skv.

    The kernel has no backward pass (the reference kernel has none
    either), so inputs that require a gradient raise on the card.
    """
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         " (same B and D, Hq a multiple of Hkv)")
    if Skv == 0:
        raise ValueError("attention needs at least one key")
    if causal and Sq > Skv:
        raise ValueError(f"causal attention with Sq={Sq} > Skv={Skv}: the "
                         "first queries would see no key")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q, k, v must share one of {list(_DTYPE_CODES)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if D > MAX_D:
        raise ValueError(f"head dim {D} > {MAX_D} is not supported")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("the flash-attention kernel has no backward pass")
    out = torch.empty((B * Hq, Sq, D), dtype=q.dtype, device=q.device)
    if Sq == 0 or B * Hq == 0:
        return out.view(B, Hq, Sq, D)
    qf = q.contiguous()
    kf = k.contiguous()
    vf = v.contiguous()
    launch = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                     out.data_ptr(), B * Hq, Sq, Skv, D, Hq // Hkv,
                     int(causal), 1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype],
                     stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out.view(B, Hq, Sq, D)
