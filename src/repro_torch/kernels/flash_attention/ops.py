"""Public wrapper for the CUDA flash-attention kernel: (B, H, S, D) with GQA.

On a CUDA tensor :func:`flash_attention` launches one of the kernel's two
bodies (``csrc/*.cu``, built at first use into one library) on the current
stream and raises if the build or the launch fails: the tensor-core body
(``flash_attention_wgmma.cu``) for bfloat16 and float16 with head dim
D ≤ 128, the CUDA-core body (``flash_attention.cu``) for the rest.
:func:`_body` makes the choice and the C entry point is told it; there is
no fallback from one body to the other.  On a CPU tensor it runs the plain
PyTorch version (``ref.py``), because the host has no kernel to launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .._build import load
from .ref import attention_ref

__all__ = ["flash_attention", "attention_ref", "LAUNCHES", "LAUNCHES_BY_BODY",
           "SOURCES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "flash_attention.cu", _CSRC / "flash_attention_wgmma.cu")
MAX_D = 256
WGMMA_MAX_D = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BODY_CODES = {"simt": 0, "wgmma": 1}

# Kernel launches made by this process (CUDA tensors only), in all and by
# body.
LAUNCHES = 0
LAUNCHES_BY_BODY = {"wgmma": 0, "simt": 0}


def _body(dtype: torch.dtype, D: int) -> str:
    """The kernel body that takes (dtype, head dim D): ``"wgmma"`` (tensor
    cores) for bfloat16 and float16 with D ≤ 128, else ``"simt"`` (float32
    FMAs on the CUDA cores): float32 inputs, and 16-bit ones with
    128 < D ≤ 256."""
    if dtype in (torch.bfloat16, torch.float16) and D <= WGMMA_MAX_D:
        return "wgmma"
    return "simt"


@functools.cache
def _launch_fn():
    """The kernel's C launch function, built and loaded once per process."""
    fn = load("flash_attention", SOURCES).flash_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _strides(t: torch.Tensor) -> list:
    """(batch, head, position) strides of a (B, H, S, D) tensor, in
    elements; a dimension of size 1 gets the stride it would have if the
    tensor were contiguous, since any stride describes it."""
    return [t.stride(i) if t.shape[i] > 1 else math.prod(t.shape[i + 1:])
            for i in range(3)]


def _tma_operand(t: torch.Tensor, Dp: int) -> torch.Tensor:
    """``t`` as the tensor-core body reads it, through TMA copies: D
    contiguous, the other strides positive multiples of 16 bytes, the base
    16-byte aligned.  A view that meets that (q, k and v as the layers hand
    them over) is passed as it is; otherwise (an expanded view's stride 0
    among them) a contiguous copy, with D padded by zeros to ``Dp`` (a
    multiple of 8)."""
    D = t.shape[-1]
    if Dp != D:
        return torch.nn.functional.pad(t, (0, Dp - D))
    elt = t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            s > 0 and s * elt % 16 == 0 for s in _strides(t)):
        return t
    return t.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """Flash attention with grouped-query heads.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), Hq % Hkv == 0, one dtype
    (float32, bfloat16 or float16).  Returns (B, Hq, Sq, D) in q's dtype.
    Query head h reads KV head h // (Hq / Hkv), as in the reference.  The
    tensor-core body (16-bit, D ≤ 128) reads q, k and v through their
    strides (q after RoPE and the head transpose is not copied) and
    returns a transposed view of (B, Sq, Hq, D) memory; the CUDA-core body
    copies inputs that are not contiguous and returns contiguous memory.

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
    if q.device.type == "meta":
        # Shapes only (the dry-run): PyTorch's fused attention op at the
        # same shapes, whose FLOPs and bytes a counter reads as a fused
        # kernel's.  No launch.
        g = q.shape[1] // k.shape[1]
        return torch.ops.aten._scaled_dot_product_flash_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
            is_causal=causal)[0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if D > MAX_D:
        raise ValueError(f"head dim {D} > {MAX_D} is not supported")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("the flash-attention kernel has no backward pass")
    body = _body(q.dtype, D)
    if body == "wgmma":
        Dp = -(-D // 8) * 8
        qf, kf, vf = (_tma_operand(t, Dp) for t in (q, k, v))
        # (B, Sq, Hq, D) memory: the layer's transpose back to (B, S, H·D)
        # is then a view.
        out = torch.empty((B, Sq, Hq, D), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
    else:
        Dp = D
        qf, kf, vf = q.contiguous(), k.contiguous(), v.contiguous()
        out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    if Sq == 0 or B * Hq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *_strides(qf), *_strides(kf), *_strides(vf), *_strides(out))
    launch = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(_BODY_CODES[body], qf.data_ptr(), kf.data_ptr(),
                     vf.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Skv, D, Dp,
                     strides, int(causal), 1.0 / math.sqrt(D),
                     _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed ({body} body): "
                           f"CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_BODY[body] += 1
    return out
