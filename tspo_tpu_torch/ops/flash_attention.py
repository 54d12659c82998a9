"""Blocked GQA flash attention — the Qwen2 prefill's attention, as a
hand-written Hopper kernel (``csrc/flash_attention.cu``).

Counterpart of ``tspo_tpu/ops/pallas_attention.py::pallas_flash_attention``
(the Pallas ``_kernel``).  q is [B, Sq, H, hd] and k/v are [B, Sk, KV, hd]
with H % KV == 0: query head h attends to kv head h // (H // KV), nothing
repeated.  Key validity is a contiguous prefix per batch row, given as
lengths; ``causal`` places the query rows at key positions
[q_offset, q_offset + Sq); ``window`` keeps q_pos - k_pos < window.

Its parts:

- :func:`flash_attention`, the wrapper: a CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel on the current stream or raises.
  It counts its kernel launches in ``flash_attention.launches``; the raw
  launch is :func:`launch`, which ``tools/compare_flash_forms.py`` also
  uses on other builds of the source.
- :func:`flash_attention_reference`, the plain PyTorch version with the
  kernel's numerics (``pallas_attention.py:79,96-97,103-104``): q.kᵀ
  accumulated in fp32, then scaled by 1/√hd; masked scores are -1e30, never
  -inf; fp32 probabilities cast to the input type before P.V, which
  accumulates in fp32; output acc / max(l, 1e-37).  It works through the
  query rows in chunks, so the card can hold the kernel against it at the
  prefill length without [H, S, S] scores.
- :func:`build`, which compiles the CUDA source at first use
  (``utils/cuda_build.py``); :func:`kernel_name` and
  :func:`kernel_attributes` say which CUDA kernel the source routes a
  (dtype, hd) to (the ``wgmma`` kernel for bf16 at hd 64 and 128) and its
  registers, shared memory and resident blocks per SM.

A query row with no valid key (only possible with a window, or a zero
length) gets a finite garbage row whose value depends on the tiling; callers
discard such rows, and the kernel is held against the plain version on the
rows that have a key.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..utils import cuda_build

_NEG = -1e30
HEAD_DIMS = (16, 64, 80, 128)   # the head dims the CUDA source instantiates
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 8
             + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# the CUDA kernels of the source, by the index tspo_flash_attention_route gives
KERNELS = ("flash_wgmma_kernel", "flash_bf16_kernel", "flash_f32_kernel")


def build() -> Path:
    """Compile ``csrc/flash_attention.cu`` (once per source hash) and return
    the shared library's path."""
    return cuda_build.build("flash_attention")


def _load() -> ctypes.CDLL:
    return cuda_build.load("flash_attention", {
        "tspo_flash_attention": _ARGTYPES,
        "tspo_flash_attention_route": [ctypes.c_int, ctypes.c_int],
        "tspo_flash_attention_attributes": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]})


def _route_args(dtype: torch.dtype, hd: int) -> tuple:
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention kernel takes bf16 or fp32, not {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes hd in {HEAD_DIMS}, got hd={hd}")
    return hd, int(dtype == torch.bfloat16)


def kernel_name(dtype: torch.dtype, hd: int) -> str:
    """The CUDA kernel a launch at (dtype, hd) runs, as the source routes it
    (builds the library)."""
    args = _route_args(dtype, hd)
    return KERNELS[_load().tspo_flash_attention_route(*args)]


def kernel_attributes(dtype: torch.dtype, hd: int) -> dict:
    """Registers a thread at launch, shared memory a block (bytes), resident
    blocks an SM and threads a block of the kernel (dtype, hd) routes to, from
    ``cudaFuncGetAttributes`` and the occupancy API on the current card."""
    args = _route_args(dtype, hd)
    out = (ctypes.c_int * 4)()
    err = _load().tspo_flash_attention_attributes(*args, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"flash_attention attributes failed: CUDA error {err}")
    return {"kernel": kernel_name(dtype, hd), "registers": out[0],
            "shared_bytes": out[1], "blocks_per_sm": out[2], "threads": out[3]}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """Validate the shapes; returns (B, Sq, Sk, H, KV, hd)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected q [B, Sq, H, hd] and k/v [B, Sk, KV, hd], "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"q/k/v shapes disagree: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} not divisible by kv heads {KV}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q/k/v dtypes differ")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q/k/v devices differ")
    return B, Sq, Sk, H, KV, hd


def _lengths(valid_k, B: int, Sk: int, device) -> torch.Tensor:
    if valid_k is None:
        return torch.full((B,), Sk, dtype=torch.int32, device=device)
    lengths = torch.as_tensor(valid_k).to(device=device, dtype=torch.int32)
    if lengths.shape != (B,):
        raise ValueError(f"valid_k must be [B] lengths, got {tuple(lengths.shape)}")
    return lengths


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, valid_len=None,
                              causal: bool = False, window: int | None = None,
                              q_offset: int = 0,
                              q_chunk: int = 1024) -> torch.Tensor:
    """Plain PyTorch version with the kernel's numerics, ``q_chunk`` query
    rows at a time.  ``valid_len`` is [B] key-prefix lengths (None: all)."""
    B, Sq, Sk, H, KV, hd = _check(q, k, v)
    G = H // KV
    lengths = _lengths(valid_len, B, Sk, q.device).clamp(0, Sk)
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(Sk, device=q.device)
    key_ok = k_pos[None, :] < lengths[:, None].long()             # [B, Sk]
    out = torch.empty_like(q)
    for r0 in range(0, Sq, q_chunk):
        n = min(q_chunk, Sq - r0)
        qc = q[:, r0:r0 + n].float().reshape(B, n, KV, G, hd)
        s = torch.einsum("bqkgd,btkd->bkgqt", qc, kf) * (1.0 / math.sqrt(hd))
        ok = key_ok[:, None, :]                                    # [B, 1, Sk]
        q_pos = q_offset + torch.arange(r0, r0 + n, device=q.device)
        if causal:
            ok = ok & (k_pos[None, :] <= q_pos[:, None])[None]
        if window is not None:
            ok = ok & (q_pos[:, None] - k_pos[None, :] < window)[None]
        s = torch.where(ok[:, None, None], s, torch.full((), _NEG, device=q.device))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1)                                          # [B, KV, G, n]
        acc = torch.einsum("bkgqt,btkd->bkgqd", p.to(q.dtype).float(), vf)
        o = acc / l.clamp_min(1e-37)[..., None]
        out[:, r0:r0 + n] = o.permute(0, 3, 1, 2, 4).reshape(B, n, H, hd).to(q.dtype)
    return out


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, lengths, causal: bool, window, q_offset: int) -> int:
    """One launch of ``lib``'s ``tspo_flash_attention`` on the current stream
    into ``out``, with no checks and no count (the wrapper's checks come
    first); returns the CUDA error code.  ``tools/compare_flash_forms.py``
    launches other builds of the source through it."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        return lib.tspo_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lengths is None else lengths.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            B, Sq, Sk, H, KV, hd, int(causal), int(window or 0),
            int(q_offset), float(1.0 / math.sqrt(hd)),
            int(q.dtype == torch.bfloat16), stream)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_k=None, causal: bool = False,
                    window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, H, hd], k/v [B, Sk, KV, hd] -> [B, Sq, H, hd].

    ``valid_k`` is [B] key-prefix lengths (None: all Sk keys valid).  CPU
    tensors take :func:`flash_attention_reference`.  CUDA tensors launch the
    Hopper kernel on ``torch.cuda.current_stream()``: bf16 or fp32, hd in
    ``HEAD_DIMS``, the head dim contiguous, 16-byte aligned rows,
    on an sm_90 card.  k/v may be strided views (a KV-cache slice): batch and
    row strides are passed to the kernel, nothing is copied.  Anything else
    raises; nothing falls back."""
    B, Sq, Sk, H, KV, hd = _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, valid_k, causal, window,
                                         q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _route_args(q.dtype, hd)
    if B > 65535 or H > 65535:
        raise ValueError(f"B={B} or H={H} exceeds the kernel grid limit 65535")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    align = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or (x.shape[2] > 1 and x.stride(2) != hd):
            raise ValueError(f"{name} must have contiguous [heads, hd] rows")
        if x.stride(1) % align or x.stride(0) % align or x.data_ptr() % 16:
            raise ValueError(f"{name} rows must be 16-byte aligned")
    cap = torch.cuda.get_device_capability(q.device)
    if cap != (9, 0):
        raise RuntimeError(f"flash_attention kernel is built for sm_90a; "
                           f"device {q.device} is sm_{cap[0]}{cap[1]}")
    lengths = None if valid_k is None else _lengths(valid_k, B, Sk, q.device)
    out = torch.empty(B, Sq, H, hd, dtype=q.dtype, device=q.device)
    err = launch(_load(), q, k, v, out, lengths, causal, window, q_offset)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
