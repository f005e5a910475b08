"""The counterparts of the JAX package's TPU probes of the commit's
matrix-unit work (``benches/exp_r4_kvar*.py``, ``exp_r4_probe.py``,
``exp_pallas_probe.py``). Each probe function's kernels map to a function
here:

  P1 exp_r4_kvar.py:47 make_call     kern_v1            plane_dot_mma (mma.sync)
                                     kern_v2            plane_dot(mode="full")
                                     kern_planes_only   plane_dot(mode="planes_only")
                                     kern_dot_only      plane_dot(mode="dot_only")
  P2 exp_r4_kvar2.py:86              batched_kernel     plane_dot(mode="full")
                                     dma_kernel         dma_checksum
  P3 exp_r4_kvar3.py:84              kmajor_kernel      plane_dot(kmajor=True)
                                     dma_kernel         dma_checksum
  P4 exp_r4_probe.py:61 probe_i8exact                   int_gemm (int8, uint8)
     exp_r4_probe.py:138 probe_dotspeed (Pallas dot)    int_gemm (int8)
  P5 exp_pallas_probe.py:18 main     k_bitcast          bitcast_u8
                                     k_dot_u8           int_gemm (uint8)
                                     k_dot_bf           bf16_gemm
                                     k_merge            merge_minor

(``plane_dot`` is kernel A of ``rings/plane_commit.py``: its full mode on
the Hopper dot, ``csrc/plane_dot_sm90_kernel.cu``, its other modes and
``plane_dot_mma`` on the mma.sync kernel.) On CUDA tensors
each function launches its kernel (``csrc/int_gemm_kernel.cu``,
``csrc/probe_kernels.cu``); on CPU tensors it runs the plain version beside
it. The benches' loop-and-perturb timing harness is not ported: the card
is timed with CUDA events (``chip_smoke.py``). u32 words are held in int32
tensors (their bit patterns) here.
"""

from __future__ import annotations

import torch

from .. import cuda
from .. import modops as mo
from .plane_commit import plane_dot, plane_dot_mma, split_k

__all__ = ["plane_dot", "plane_dot_mma", "dma_checksum", "int_gemm", "bf16_gemm", "bitcast_u8", "merge_minor"]

_GEMM_TYPES = {torch.int8: 0, torch.uint8: 1}
_BLOCKS_PER_SM = 4  # DMA checksum blocks per SM


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# DMA checksum
# ---------------------------------------------------------------------------


def dma_checksum_plain(a, w):
    """Per component c: (sum of a[c] as int8 + sum of w[c] as u32) mod 2^32,
    as int64 [c]."""
    c = a.shape[0]
    sa = a.reshape(c, -1).long().sum(1)
    sw = (w.reshape(c, -1).long() & mo.MASK32).sum(1)
    return (sa + sw) & mo.MASK32


def dma_checksum(a, w):
    """a: [c, ...] int8 (either layout of the commit's lhs), w: [c, ...] u32
    words in int32 -> the checksum of ``dma_checksum_plain``, int64 [c]."""
    if a.device.type == "cpu":
        return dma_checksum_plain(a, w)
    c = a.shape[0]
    if a.dtype != torch.int8 or w.dtype != torch.int32 or not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("dma_checksum: contiguous int8 a and int32 w expected")
    a_bytes, w_words = a[0].numel(), w[0].numel()
    if a_bytes % 16 or w_words % 4 or a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("dma_checksum: per-component sizes and pointers must be multiples of 16 bytes")
    out = torch.zeros(c, dtype=torch.int32, device=a.device)
    blocks = max(1, _BLOCKS_PER_SM * _sms(a.device) // c)
    code = cuda.kernel("dma_checksum")(
        a.data_ptr(), a_bytes, w.data_ptr(), w_words, out.data_ptr(), c, blocks,
        cuda.stream_handle(a.device),
    )
    cuda.check(code, "dma_checksum")
    cuda.LAUNCHES["dma_checksum"] += 1
    return out.long() & mo.MASK32


# ---------------------------------------------------------------------------
# GEMMs on the tensor cores
# ---------------------------------------------------------------------------


def int_gemm_plain(a, b):
    """a [M, K] @ b [K, N], both int8 or both uint8 -> int32, exact: the
    products sum in float64 (below 2^53 for K < 2^37)."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def bf16_gemm_plain(a, b):
    """uint8 a [M, K] @ b [K, N] -> float32 sums of the values, exact while
    they stay below 2^24 (K 255^2 < 2^24 for K <= 256)."""
    return torch.matmul(a.double(), b.double()).to(torch.float32)


def _gemm_kernel(a, b, type_code: int, out_dtype):
    dev = a.device
    if b.device != dev or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("int_gemm: contiguous a and b on one device expected")
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"int_gemm: {tuple(a.shape)} @ {tuple(b.shape)}")
    ksplit = split_k(-(-M // 64) * -(-N // 64), K, _sms(dev))
    out = (torch.zeros if ksplit > 1 else torch.empty)((M, N), dtype=out_dtype, device=dev)
    vec = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0 and K % 16 == 0 and N % 16 == 0
    code = cuda.kernel("int_gemm")(
        a.data_ptr(), K, b.data_ptr(), N, out.data_ptr(), N, M, N, K, type_code, ksplit,
        int(vec), cuda.stream_handle(dev),
    )
    cuda.check(code, "int_gemm")
    cuda.LAUNCHES["int_gemm"] += 1
    return out


def int_gemm(a, b):
    """Kernel C, instances s8 and u8: a [M, K] @ b [K, N] -> int32 [M, N]
    (both int8 or both uint8)."""
    if a.dtype != b.dtype or a.dtype not in _GEMM_TYPES:
        raise ValueError(f"int_gemm: int8 or uint8 operands expected, got {a.dtype} and {b.dtype}")
    if a.device.type == "cpu":
        return int_gemm_plain(a, b)
    return _gemm_kernel(a, b, _GEMM_TYPES[a.dtype], torch.int32)


def bf16_gemm(a, b):
    """Kernel C, instance bf16: uint8 a [M, K] @ b [K, N], the values taken
    as bf16, summed in float32 -> float32 [M, N]."""
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise ValueError("bf16_gemm: uint8 operands expected")
    if a.device.type == "cpu":
        return bf16_gemm_plain(a, b)
    return _gemm_kernel(a, b, 2, torch.float32)


# ---------------------------------------------------------------------------
# relayouts
# ---------------------------------------------------------------------------


def bitcast_u8(x):
    """u32 words [R, W] (int32) -> their little-endian bytes [R, 4 W] uint8."""
    if x.device.type == "cpu":
        return x.contiguous().view(torch.uint8)
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("bitcast_u8: a contiguous int32 tensor expected")
    out = torch.empty(x.shape[:-1] + (4 * x.shape[-1],), dtype=torch.uint8, device=x.device)
    code = cuda.kernel("bitcast")(x.data_ptr(), x.numel(), out.data_ptr(), cuda.stream_handle(x.device))
    cuda.check(code, "bitcast")
    cuda.LAUNCHES["bitcast"] += 1
    return out


def merge_minor(y):
    """[R, X, NL] u32 words (int32) -> [R, X NL]."""
    R, X, NL = y.shape
    if y.device.type == "cpu":
        return y.reshape(R, X * NL).clone()
    if y.dtype != torch.int32 or not y.is_contiguous():
        raise ValueError("merge_minor: a contiguous int32 tensor expected")
    out = torch.empty((R, X * NL), dtype=torch.int32, device=y.device)
    code = cuda.kernel("merge")(y.data_ptr(), R, X, NL, out.data_ptr(), cuda.stream_handle(y.device))
    cuda.check(code, "merge")
    cuda.LAUNCHES["merge"] += 1
    return out
