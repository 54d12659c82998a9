"""The kernels of the ViT-attention variant bench, as hand-written Hopper
kernels, each beside its plain PyTorch version.

Counterparts of the Pallas kernels of ``scripts/bench_vit_attention_variants.py``
(the JAX package's attribution bench for ``vit_attention``).  Every function
takes and returns bf16 in the JAX layouts: q, k, v and o are [B, S, W] with
W = heads * hd, the packed input is [B, S, 3W].  Inside, scores, softmax and
accumulation are fp32 and the probabilities are rounded to bf16 after the
division, as in the Pallas bodies.

========================  ==========================  ===========================
Pallas kernel (file:line)  wrapper                     CUDA source (``csrc/``)
========================  ==========================  ===========================
``_lane_kernel`` :43       :func:`lane_attention`      ``vit_attention_lane.cu``
``_lane_fn_kernel`` :67    :func:`lane_attention`      (``frames=F``)
``_grid_h2_kernel`` :228   :func:`lane_attention`      (``heads_per_block=2``)
``_lane_packed_kernel``    :func:`lane_packed_attention`
:212
``_bdp2_kernel`` :114      :func:`bdp2_attention`
``_manual_dma_kernel``     :func:`pipelined_attention` ``vit_attention_pipelined.cu``
:152
``_dma_kernel`` :97,       :func:`dma_add`             ``dma_probe.cu``
``_dma_fn_kernel`` :102
``_gemm_inkernel`` :106    :func:`gemm`                ``inkernel_gemm.cu``
``_fullwidth_kernel`` :85  :func:`fullwidth_attention` (:func:`gemm`,
                           :func:`row_softmax`,
                           :func:`gemm`)
========================  ==========================  ===========================

Each wrapper takes its plain version (``*_reference``) for a CPU tensor; for a
CUDA tensor it launches its kernel on the current stream or raises, and counts
the launch in ``<wrapper>.launches``.  The kernels take bf16 only (fp32 scores
for :func:`row_softmax`), contiguous 16-byte aligned rows, and an sm_90 card;
the attention kernels take hd = 64 only, the head width of every bench shape.
:func:`build` compiles one source with ``nvcc`` at first use
(``utils/cuda_build.py``).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..utils import cuda_build

SOURCES = ("vit_attention_lane", "vit_attention_pipelined", "dma_probe",
           "inkernel_gemm")
MODES = {"max": 0, "nomax": 1, "none": 2}
KERNEL_HD = 64            # the head dim the attention sources take
LANE_MAX_S = 768          # score rows of one head in shared memory
BDP2_MAX_S = 320          # score rows of one head pair
PIPELINED_MAX_S = 288     # two stages of q, k, v slices in shared memory

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SYMBOLS = {
    "vit_attention_lane": {
        "tspo_lane_attention": [_P] * 4 + [_I] * 8 + [_F, _P],
        "tspo_lane_packed_attention": [_P] * 2 + [_I] * 4 + [_F, _P],
        "tspo_bdp2_attention": [_P] * 4 + [_I] * 4 + [_F, _P],
    },
    "vit_attention_pipelined": {
        "tspo_pipelined_attention": [_P] * 4 + [_I] * 5 + [_F, _P],
    },
    "dma_probe": {"tspo_dma_add": [_P] * 3 + [_I] * 4 + [_P]},
    "inkernel_gemm": {
        "tspo_gemm": [_P] * 3 + [_I] * 3 + [_L] * 6 + [_I] * 3 + [_P],
        "tspo_row_softmax": [_P] * 2 + [_L, _I, _L, _L, _F, _P],
    },
}


def build(source: str) -> Path:
    """Compile ``csrc/<source>.cu`` (once per source hash) and return the
    shared library's path; ``source`` is one of :data:`SOURCES`."""
    if source not in SOURCES:
        raise ValueError(f"unknown source {source!r}; one of {SOURCES}")
    return cuda_build.build(source)


def _launch(source: str, symbol: str, device: torch.device, *args) -> None:
    lib = cuda_build.load(source, _SYMBOLS[source])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


def _on_card(x: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA tensor;
    raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def _check_sm90(name: str, device: torch.device) -> None:
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(f"{name} kernel is built for sm_90a; device {device} "
                           f"is sm_{cap[0]}{cap[1]}")


def _kernel_ready(name: str, **tensors: torch.Tensor) -> None:
    """What the attention and add kernels take: bf16, contiguous, 16-byte
    aligned, on an sm_90 card."""
    for label, x in tensors.items():
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} kernel takes bf16, not {x.dtype} ({label})")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    _check_sm90(name, next(iter(tensors.values())).device)


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               heads: int) -> int:
    """Shapes, types and devices agree; returns the head dim."""
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


def _kernel_shape(name: str, hd: int, S: int, max_s: int) -> None:
    if hd != KERNEL_HD:
        raise ValueError(f"{name} kernel takes hd={KERNEL_HD}, got hd={hd}")
    if S > max_s:
        raise ValueError(f"{name} kernel takes S <= {max_s}, got S={S}")


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


# ---------------------------------------------------------------- plain versions

def lane_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             heads: int, mode: str = "max") -> torch.Tensor:
    """Plain version of ``_lane_kernel`` (and ``_lane_fn_kernel``,
    ``_grid_h2_kernel``, ``_lane_packed_kernel``, ``_manual_dma_kernel``):
    per head, s = (q kᵀ)·scale in fp32; mode ``max``: e = exp(s - max),
    p = e / Σe; ``nomax``: e = exp(s), p = e / Σe; ``none``: p = s·0.001;
    p rounded to the input type, o = p v accumulated in fp32."""
    hd = _check_qkv(q, k, v, heads)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    B, S, W = q.shape
    qh = q.reshape(B, S, heads, hd).float()
    kh = k.reshape(B, S, heads, hd).float()
    vh = v.reshape(B, S, heads, hd).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (1.0 / math.sqrt(hd))
    if mode == "none":
        p = s * 0.001
    else:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True) if mode == "max" else s)
        p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), vh)
    return out.to(q.dtype).reshape(B, S, W)


def lane_packed_reference(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain version of ``_lane_packed_kernel``: exact attention with q, k
    and v at column offsets 0, W and 2W of one [B, S, 3W] input."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"expected a packed [B, S, 3W] input, got {tuple(qkv.shape)}")
    q, k, v = qkv.chunk(3, dim=-1)
    return lane_attention_reference(q, k, v, heads)


def bdp2_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """Plain version of ``_bdp2_kernel``, step by step: for each head pair,
    K and V packed block-diagonally into [2S, 2·hd] (the other head's half
    zero), one contraction over the pair's 2·hd lanes gives [S, 2S] scores,
    a softmax segmented by -1e30 masks over the two column halves, and one
    product with V packed the same way.  Equal to exact attention."""
    hd = _check_qkv(q, k, v, heads)
    if heads % 2:
        raise ValueError(f"bdp2 packs heads in pairs; got {heads} heads")
    B, S, W = q.shape
    P, L = heads // 2, 2 * hd
    q2 = q.reshape(B, S, P, L).float()
    kp = k.reshape(B, S, P, 2, hd).float().permute(0, 2, 3, 1, 4)  # [B, P, 2, S, hd]
    vp = v.reshape(B, S, P, 2, hd).float().permute(0, 2, 3, 1, 4)
    kbd = q.new_zeros(B, P, 2 * S, L, dtype=torch.float32)
    vbd = torch.zeros_like(kbd)
    kbd[:, :, :S, :hd], kbd[:, :, S:, hd:] = kp[:, :, 0], kp[:, :, 1]
    vbd[:, :, :S, :hd], vbd[:, :, S:, hd:] = vp[:, :, 0], vp[:, :, 1]
    s2 = torch.einsum("bqpl,bpjl->bpqj", q2, kbd) * (1.0 / math.sqrt(hd))
    is_b = torch.arange(2 * S, device=q.device) >= S
    neg = torch.tensor(-1e30, device=q.device)
    m_a = torch.where(is_b, neg, s2).amax(dim=-1, keepdim=True)
    m_b = torch.where(is_b, s2, neg).amax(dim=-1, keepdim=True)
    e = torch.exp(s2 - torch.where(is_b, m_b, m_a))
    d_a = torch.where(is_b, 0.0, e).sum(dim=-1, keepdim=True)
    d_b = torch.where(is_b, e, 0.0).sum(dim=-1, keepdim=True)
    p2 = (e / torch.where(is_b, d_b, d_a)).to(q.dtype)
    out = torch.einsum("bpqj,bpjl->bqpl", p2.float(), vbd)
    return out.to(q.dtype).reshape(B, S, W)


def pipelined_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, heads: int,
                                  copy: bool = False) -> torch.Tensor:
    """Plain version of ``_manual_dma_kernel``: exact attention, or o = q
    for the copy probe (the Pallas kernel with heads = 0)."""
    _check_qkv(q, k, v, heads)
    return q.clone() if copy else lane_attention_reference(q, k, v, heads)


def dma_add_reference(q: torch.Tensor, k: torch.Tensor,
                      rows: int | None = None) -> torch.Tensor:
    """Plain version of ``_dma_kernel`` / ``_dma_fn_kernel``:
    o = q + bf16(f32(k)) over the first ``rows`` rows of each frame, the sum
    taken in fp32 and rounded once."""
    rows = _dma_rows(q, k, rows)
    return (q[:, :rows].float() + k[:, :rows].float()).to(q.dtype)


def gemm_reference(a: torch.Tensor, b: torch.Tensor, trans_b: bool = False,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of ``_gemm_inkernel``'s product: a @ b (a @ bᵀ with
    ``trans_b``) in fp32, rounded to ``out_dtype``."""
    bf = b.float().transpose(-1, -2) if trans_b else b.float()
    return (a.float() @ bf).to(out_dtype)


def row_softmax_reference(s: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(s·scale) over the last dim in fp32, rounded to bf16 after the
    division."""
    x = s.float() * scale
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16)


def fullwidth_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """Plain version of ``_fullwidth_kernel`` (attribution only, not
    attention): one "head" over all W lanes, softmax((q kᵀ)·scale) v with
    scale = 1/√(W/heads)."""
    hd = _check_qkv(q, k, v, heads)
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    return (p.float() @ v.float()).to(q.dtype)


# ---------------------------------------------------------------- wrappers

def lane_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int, mode: str = "max", transpose_k: bool = False,
                   frames: int = 1, heads_per_block: int | None = None
                   ) -> torch.Tensor:
    """One-shot-softmax attention over lane slices (``vit_attention_lane.cu``).

    ``mode`` as in :func:`lane_attention_reference`; ``transpose_k`` writes
    Kᵀ into shared memory (the ``lane`` variant, mode ``max`` only);
    ``frames`` frames per block (``lane_f{F}``, B % frames == 0);
    ``heads_per_block`` heads a block loops over (all by default; 2 for
    ``grid_h2``).  The options choose the kernel's blocking, not the
    function."""
    hd = _check_qkv(q, k, v, heads)
    hpb = heads if heads_per_block is None else heads_per_block
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    if transpose_k and mode != "max":
        raise ValueError("transpose_k is the lane variant: mode 'max' only")
    if frames <= 0 or q.shape[0] % frames:
        raise ValueError(f"batch {q.shape[0]} not divisible by frames {frames}")
    if hpb <= 0 or heads % hpb:
        raise ValueError(f"heads {heads} not divisible by heads_per_block {hpb}")
    if not _on_card(q):
        return lane_attention_reference(q, k, v, heads, mode)
    B, S, W = q.shape
    _kernel_shape("lane_attention", hd, S, LANE_MAX_S)
    if B // frames > 65535:
        raise ValueError(f"batch {B} / frames {frames} exceeds the grid limit 65535")
    _kernel_ready("lane_attention", q=q, k=k, v=v)
    out = torch.empty_like(q)
    _launch("vit_attention_lane", "tspo_lane_attention", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, W,
            heads, MODES[mode], int(transpose_k), frames, hpb,
            1.0 / math.sqrt(hd))
    lane_attention.launches += 1
    return out


def lane_packed_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Exact attention read from one packed [B, S, 3W] input (q, k, v at
    column offsets 0, W, 2W; ``vit_attention_lane.cu`` with row stride 3W)."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"expected a packed [B, S, 3W] input, got {tuple(qkv.shape)}")
    B, S, W3 = qkv.shape
    W = W3 // 3
    if heads <= 0 or W % heads:
        raise ValueError(f"width {W} not divisible by heads {heads}")
    if not _on_card(qkv):
        return lane_packed_reference(qkv, heads)
    _kernel_shape("lane_packed_attention", W // heads, S, LANE_MAX_S)
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid limit 65535")
    _kernel_ready("lane_packed_attention", qkv=qkv)
    out = qkv.new_empty(B, S, W)
    _launch("vit_attention_lane", "tspo_lane_packed_attention", qkv.device,
            qkv.data_ptr(), out.data_ptr(), B, S, W, heads,
            1.0 / math.sqrt(W // heads))
    lane_packed_attention.launches += 1
    return out


def bdp2_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """Exact attention two heads at a time, K and V packed block-diagonally
    (``vit_attention_lane.cu``, block-diagonal mode)."""
    hd = _check_qkv(q, k, v, heads)
    if heads % 2:
        raise ValueError(f"bdp2 packs heads in pairs; got {heads} heads")
    if not _on_card(q):
        return bdp2_reference(q, k, v, heads)
    B, S, W = q.shape
    _kernel_shape("bdp2_attention", hd, S, BDP2_MAX_S)
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid limit 65535")
    _kernel_ready("bdp2_attention", q=q, k=k, v=v)
    out = torch.empty_like(q)
    _launch("vit_attention_lane", "tspo_bdp2_attention", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, W,
            heads, 1.0 / math.sqrt(hd))
    bdp2_attention.launches += 1
    return out


def pipelined_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int, copy: bool = False) -> torch.Tensor:
    """Exact attention (or o = q with ``copy``) by a persistent grid that
    double-buffers (frame, head) items (``vit_attention_pipelined.cu``)."""
    hd = _check_qkv(q, k, v, heads)
    if not _on_card(q):
        return pipelined_attention_reference(q, k, v, heads, copy)
    B, S, W = q.shape
    _kernel_shape("pipelined_attention", hd, S, PIPELINED_MAX_S)
    _kernel_ready("pipelined_attention", q=q, k=k, v=v)
    out = torch.empty_like(q)
    _launch("vit_attention_pipelined", "tspo_pipelined_attention", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, W,
            heads, int(copy), 1.0 / math.sqrt(hd))
    pipelined_attention.launches += 1
    return out


def _dma_rows(q: torch.Tensor, k: torch.Tensor, rows: int | None) -> int:
    if q.dim() != 3 or k.shape != q.shape:
        raise ValueError(f"expected equal [B, S, W] inputs, got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    if q.dtype != k.dtype or q.device != k.device:
        raise ValueError("q/k dtypes or devices differ")
    rows = q.shape[1] if rows is None else rows
    if not 0 < rows <= q.shape[1]:
        raise ValueError(f"rows must be in 1..{q.shape[1]}, got {rows}")
    return rows


def dma_add(q: torch.Tensor, k: torch.Tensor, rows: int | None = None
            ) -> torch.Tensor:
    """o = q + bf16(f32(k)) over the first ``rows`` rows of each frame
    (all by default), read in place (``dma_probe.cu``)."""
    rows = _dma_rows(q, k, rows)
    if not _on_card(q):
        return dma_add_reference(q, k, rows)
    B, S, W = q.shape
    if W % 8:
        raise ValueError(f"dma_add kernel takes W % 8 == 0, got W={W}")
    _kernel_ready("dma_add", q=q, k=k)
    out = q.new_empty(B, rows, W)
    _launch("dma_probe", "tspo_dma_add", q.device, q.data_ptr(), k.data_ptr(),
            out.data_ptr(), B, S, rows, W)
    dma_add.launches += 1
    return out


def _matrix_view(name: str, x: torch.Tensor) -> tuple:
    """(batch, rows, cols, row stride, batch stride) of a 2-D or 3-D operand
    whose rows are contiguous and 16-byte aligned."""
    if x.dim() not in (2, 3):
        raise ValueError(f"gemm takes 2-D or 3-D operands, got {tuple(x.shape)} ({name})")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"gemm kernel takes bf16, not {x.dtype} ({name})")
    if x.stride(-1) != 1 or x.stride(-2) % 8 or x.data_ptr() % 16:
        raise ValueError(f"gemm: {name} needs contiguous rows with a row stride "
                         f"that is a multiple of 8 and a 16-byte aligned base")
    batch = x.shape[0] if x.dim() == 3 else 1
    bstride = x.stride(0) if x.dim() == 3 else 0
    if bstride % 8:
        raise ValueError(f"gemm: {name}'s batch stride must be a multiple of 8")
    return batch, x.shape[-2], x.shape[-1], x.stride(-2), bstride


def gemm(a: torch.Tensor, b: torch.Tensor, trans_b: bool = False,
         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """a [.., M, K] @ b [.., K, N] (b [.., N, K] with ``trans_b``), batched
    over a leading dim, fp32 accumulation (``inkernel_gemm.cu``).  Operands
    may be strided views whose rows are contiguous and 16-byte aligned; the
    output is [.., M, N] in ``out_dtype`` (bf16 or fp32), a view of a buffer
    whose rows are padded to a multiple of 8."""
    if a.dim() != b.dim() or a.device != b.device:
        raise ValueError("gemm operands differ in rank or device")
    K = a.shape[-1]
    if (b.shape[-1] if trans_b else b.shape[-2]) != K:
        raise ValueError(f"gemm: inner dims differ, {tuple(a.shape)} and "
                         f"{tuple(b.shape)} (trans_b={trans_b})")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gemm writes bf16 or fp32, not {out_dtype}")
    if not _on_card(a):
        return gemm_reference(a, b, trans_b, out_dtype)
    batch, M, _, lda, sa = _matrix_view("a", a)
    batch_b, _, _, ldb, sb = _matrix_view("b", b)
    if batch_b != batch:
        raise ValueError(f"gemm: batch {batch} and {batch_b} differ")
    N = b.shape[-2] if trans_b else b.shape[-1]
    _check_sm90("gemm", a.device)
    ldc = _round8(N)
    out = torch.empty(batch, M, ldc, dtype=out_dtype, device=a.device)
    _launch("inkernel_gemm", "tspo_gemm", a.device, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), M, N, K, lda, ldb, ldc, sa, sb, M * ldc, batch,
            int(trans_b), int(out_dtype == torch.float32))
    gemm.launches += 1
    out = out[..., :N]
    return out if a.dim() == 3 else out[0]


def row_softmax(s: torch.Tensor, scale: float) -> torch.Tensor:
    """bf16 softmax(s·scale) over the last dim of fp32 scores
    (``inkernel_gemm.cu``).  ``s`` may be a view with padded rows (as
    :func:`gemm` returns); the output is a view of a buffer whose rows are
    padded to a multiple of 8 with zeros."""
    if s.dim() not in (2, 3):
        raise ValueError(f"row_softmax takes 2-D or 3-D scores, got {tuple(s.shape)}")
    if not _on_card(s):
        return row_softmax_reference(s, scale)
    if s.dtype != torch.float32:
        raise ValueError(f"row_softmax kernel takes fp32 scores, not {s.dtype}")
    R, N = s.shape[-2:]
    ld = s.stride(-2)
    if s.stride(-1) != 1 or ld < N or (s.dim() == 3 and s.stride(0) != R * ld):
        raise ValueError("row_softmax: scores need contiguous rows of one stride")
    if s.data_ptr() % 16:
        raise ValueError("row_softmax: scores must be 16-byte aligned")
    _check_sm90("row_softmax", s.device)
    batch = s.shape[0] if s.dim() == 3 else 1
    ldo = _round8(N)
    out = torch.empty(batch, R, ldo, dtype=torch.bfloat16, device=s.device)
    _launch("inkernel_gemm", "tspo_row_softmax", s.device, s.data_ptr(),
            out.data_ptr(), batch * R, N, ld, ldo, float(scale))
    row_softmax.launches += 1
    out = out[..., :N]
    return out if s.dim() == 3 else out[0]


def fullwidth_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """The ``fullwidth`` probe (attribution only): one "head" of width W,
    softmax((q kᵀ)·scale) v with scale = 1/√(W/heads), as three launches:
    :func:`gemm` q kᵀ to fp32, :func:`row_softmax`, :func:`gemm` P v."""
    hd = _check_qkv(q, k, v, heads)
    if not _on_card(q):
        return fullwidth_reference(q, k, v, heads)
    s = gemm(q, k, trans_b=True, out_dtype=torch.float32)
    p = row_softmax(s, 1.0 / math.sqrt(hd))
    return gemm(p, v)


WRAPPERS = (lane_attention, lane_packed_attention, bdp2_attention,
            pipelined_attention, dma_add, gemm, row_softmax)
for _fn in WRAPPERS:
    _fn.launches = 0
