"""Unmasked multi-head ViT attention over [B, S, W] — the CLIP/SigLIP towers'
attention, as a hand-written Hopper kernel (``csrc/vit_attention.cu``).

Counterpart of ``tspo_tpu/ops/vit_attention.py::vit_attention`` (the Pallas
``_lane_kernel``).  q, k and v stay in their natural GEMM-output layout
[B, S, W] with W = heads * hd; per head the kernel reads the lane slice
[:, h*hd:(h+1)*hd], computes softmax(q kᵀ/√hd) in fp32, casts the
probabilities to the input type and multiplies by v with fp32 accumulation.

Its parts:

- :func:`vit_attention`, the wrapper: a CPU tensor goes to the plain version;
  a CUDA tensor launches the kernel on the current stream or raises.  It
  counts its kernel launches in ``vit_attention.launches``.
- :func:`vit_attention_reference`, the plain PyTorch version with the same
  numerics.  The CPU tests use it and ``chip_smoke.py`` holds the kernel
  against it on the card.
- :func:`build`, which compiles the CUDA source with ``nvcc`` for sm_90a into
  a shared library with a plain C interface at first use, keyed by a hash of
  the source (``utils/cuda_build.py``, shared by every kernel);
  :func:`kernel_name` and :func:`kernel_attributes` say which CUDA kernel the
  source routes a (dtype, hd) to (``vit_attention_wgmma_kernel`` for bf16 at
  hd 64 and 72, in its "resident" form for hd 64 up to S = 264 and its
  "streamed" form otherwise; ``vit_attention_bf16_kernel`` for the other bf16
  head dims; ``vit_attention_f32_kernel`` for fp32) and its registers, shared
  memory and resident blocks per SM.  :func:`launch` is the raw launch,
  which ``tools/compare_flash_forms.py --kernel vit_attention`` also uses on
  other builds of the source.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..utils import cuda_build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# the CUDA kernels of the source, by the index tspo_vit_attention_route gives
KERNELS = ("vit_attention_wgmma_kernel", "vit_attention_bf16_kernel",
           "vit_attention_f32_kernel")
FORMS = ("resident", "streamed")   # vit_attention_wgmma_kernel's two forms


def build() -> Path:
    """Compile ``csrc/vit_attention.cu`` (once per source hash) and return
    the shared library's path."""
    return cuda_build.build("vit_attention")


def _load() -> ctypes.CDLL:
    return cuda_build.load("vit_attention", {
        "tspo_vit_attention": _ARGTYPES,
        "tspo_vit_attention_route": [ctypes.c_int, ctypes.c_int],
        "tspo_vit_attention_attributes": [ctypes.c_int] * 3 + [ctypes.c_void_p]})


def _route_args(dtype: torch.dtype, hd: int) -> tuple:
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"vit_attention kernel takes bf16 or fp32, not {dtype}")
    if hd <= 0 or hd % 8 or hd > 128:
        raise ValueError(f"vit_attention kernel takes hd % 8 == 0 and hd <= 128, "
                         f"got hd={hd}")
    return hd, int(dtype == torch.bfloat16)


def kernel_name(dtype: torch.dtype, hd: int) -> str:
    """The CUDA kernel a launch at (dtype, hd) runs, as the source routes it
    (builds the library)."""
    args = _route_args(dtype, hd)
    return KERNELS[_load().tspo_vit_attention_route(*args)]


def kernel_attributes(dtype: torch.dtype, hd: int, seq: int) -> dict:
    """Registers a thread at launch, shared memory a block (bytes), resident
    blocks an SM and threads a block of the kernel a launch at (dtype, hd,
    sequence length ``seq``) runs, and its form (None outside the wgmma
    kernel), from ``cudaFuncGetAttributes`` and the occupancy API on the
    current card."""
    args = _route_args(dtype, hd)
    out = (ctypes.c_int * 5)()
    err = _load().tspo_vit_attention_attributes(*args, seq, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"vit_attention attributes failed: CUDA error {err}")
    return {"kernel": kernel_name(dtype, hd),
            "form": FORMS[out[4]] if out[4] >= 0 else None,
            "registers": out[0], "shared_bytes": out[1], "blocks_per_sm": out[2],
            "threads": out[3]}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           heads: int) -> int:
    """Validate what the kernel takes; returns the head dim."""
    if q.dim() != 3:
        raise ValueError(f"expected [B, S, W] inputs, got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q/k/v dtypes differ")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q/k/v devices differ")
    W = q.shape[-1]
    if heads <= 0 or W % heads:
        raise ValueError(f"width {W} not divisible by heads {heads}")
    return W // heads


def vit_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            heads: int) -> torch.Tensor:
    """Plain PyTorch version: the kernel's numerics, one head-batched einsum
    at a time (fp32 scores and softmax, probabilities cast to the input type,
    fp32 accumulation of P @ V)."""
    hd = _check(q, k, v, heads)
    B, S, W = q.shape
    qh = q.reshape(B, S, heads, hd).float()
    kh = k.reshape(B, S, heads, hd).float()
    vh = v.reshape(B, S, heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (1.0 / np.sqrt(hd))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), vh.float())
    return out.to(q.dtype).reshape(B, S, W)


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, heads: int) -> int:
    """One launch of ``lib``'s ``tspo_vit_attention`` on the current stream
    into ``out``, with no checks and no count (the wrapper's checks come
    first); returns the CUDA error code."""
    B, S, W = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        return lib.tspo_vit_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, W, heads, float(1.0 / np.sqrt(W // heads)),
            int(q.dtype == torch.bfloat16), stream)


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """Unmasked multi-head attention over [B, S, W] (W = heads * hd).

    CPU tensors take :func:`vit_attention_reference`.  CUDA tensors launch
    the Hopper kernel on ``torch.cuda.current_stream()``: bf16 or fp32,
    contiguous, 16-byte aligned, hd a multiple of 8 up to 128, on an sm_90
    card.  Anything else raises, and so does a launch the card refuses (a
    tensor map that cannot be encoded among them); nothing falls back."""
    hd = _check(q, k, v, heads)
    if q.device.type == "cpu":
        return vit_attention_reference(q, k, v, heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _route_args(q.dtype, hd)
    B, S, W = q.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel grid limit 65535")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    cap = torch.cuda.get_device_capability(q.device)
    if cap != (9, 0):
        raise RuntimeError(f"vit_attention kernel is built for sm_90a; "
                           f"device {q.device} is sm_{cap[0]}{cap[1]}")
    out = torch.empty_like(q)
    err = launch(_load(), q, k, v, out, heads)
    if err != 0:
        raise RuntimeError(f"vit_attention kernel launch failed: CUDA error {err}")
    vit_attention.launches += 1
    return out


vit_attention.launches = 0
