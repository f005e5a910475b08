"""The counterparts of the JAX package's TPU probes of the commit's
matrix-unit work (``benches/exp_r4_kvar*.py``, ``exp_r4_probe.py``,
``exp_pallas_probe.py``). Each probe function's kernels map to a function
here:

  P1 exp_r4_kvar.py:47 make_call     kern_v1            plane_dot(mode="full") (plane_dot_mma:
                                                        the mma.sync baseline)
                                     kern_v2            plane_dot(mode="full")
                                     kern_planes_only   plane_dot(mode="planes_only")
                                     kern_dot_only      plane_dot(mode="dot_only")
  P2 exp_r4_kvar2.py:86              batched_kernel     plane_dot(mode="full")
                                     dma_kernel         dma_checksum
  P3 exp_r4_kvar3.py:84              kmajor_kernel      plane_dot(kmajor=True)
                                     dma_kernel         dma_checksum
  P4 exp_r4_probe.py:61 probe_i8exact                   int_gemm (int8, uint8)
     exp_r4_probe.py:138 probe_dotspeed (Pallas dot)    int_gemm (int8)
                                                        (int_gemm_mma: the first design)
  P5 exp_pallas_probe.py:18 main     k_bitcast          bitcast_u8
                                     k_dot_u8           int_gemm (uint8)
                                     k_dot_bf           bf16_gemm (bf16_gemm_mma: the first design)
                                     k_merge            merge_minor

(``plane_dot`` is kernel A of ``rings/plane_commit.py``: its full and
dot-only modes and its K-major lhs on the Hopper dot,
``csrc/plane_dot_sm90_kernel.cu``, ``planes_only`` and ``plane_dot_mma``,
the baseline, on the mma.sync kernel.) On CUDA tensors each function
launches its kernel: ``int_gemm`` kernel C's Hopper GEMM
(``csrc/int_gemm_sm90_kernel.cu``), ``bf16_gemm`` its bf16 instance on
Hopper (``csrc/bf16_gemm_sm90_kernel.cu``), ``int_gemm_mma`` and
``bf16_gemm_mma`` their first design (``csrc/int_gemm_kernel.cu``), the
rest ``csrc/probe_kernels.cu``; on CPU tensors it runs the plain version
beside it. The benches' loop-and-perturb timing harness is not ported: the card
is timed with CUDA events (``chip_smoke.py``). u32 words are held in int32
tensors (their bit patterns) here.
"""

from __future__ import annotations

import functools

import torch

from .. import cuda
from .. import modops as mo
from .plane_commit import plane_dot, plane_dot_mma, split_k

__all__ = ["plane_dot", "plane_dot_mma", "dma_checksum", "int_gemm", "int_gemm_mma", "bf16_gemm", "bf16_gemm_mma",
           "bitcast_u8", "merge_minor"]

_GEMM_TYPES = {torch.int8: 0, torch.uint8: 1}
_BLOCKS_PER_SM = 4  # DMA checksum blocks per SM
_GEMM_WIDTHS = (8, 64, 128, 192)  # the Hopper GEMM's row-group widths n
_GEMM_SMALL_M = 512  # up to this M the GEMM takes row groups of 64 (more blocks)
_GEMM_COLS = 128  # the columns of B a block of the Hopper GEMM owns (csrc: 4 Cfg::WT)
_GEMM_MIN_SPLIT_K = 256  # the least K a split of the Hopper GEMM takes
_GEMM_MAX_SPLIT = 64  # the most splits: the last split to arrive adds the others
_GEMM_CONSUMERS = 256  # consumer threads a block (csrc: GEMM_THREADS)
BF16_K_MAX = 258  # the largest K whose float32 sums of u8 products are exact: 255^2 K < 2^24


@functools.lru_cache(maxsize=None)
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
    """uint8 a [M, K] @ b [K, N] -> the exact integer sums rounded once to
    float32 (exact themselves while below 2^24: 255^2 K < 2^24 for K <=
    BF16_K_MAX)."""
    return torch.matmul(a.double(), b.double()).to(torch.float32)


def _gemm_shape(a, b):
    """(M, K, N) of a [M, K] @ b [K, N] on one device, or raise."""
    if b.device != a.device:
        raise ValueError("int_gemm: a and b on one device expected")
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"int_gemm: {tuple(a.shape)} @ {tuple(b.shape)}")
    return M, K, N


def _gemm_kernel(a, b, type_code: int, out_dtype):
    dev = a.device
    M, K, N = _gemm_shape(a, b)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("int_gemm: contiguous a and b expected")
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


def gemm_groups(m: int):
    """The Hopper GEMM's row groups for ``m`` rows of A: (groups, n). Up to
    _GEMM_SMALL_M rows, groups of 64 (of 8 for m <= 8), so that a small,
    launch-bound GEMM spreads over more blocks; above, the fewest groups of
    at most 192 rows, n the least instantiated width that holds an equal
    share (m 1728: nine of 192)."""
    if m <= _GEMM_WIDTHS[0]:
        return 1, _GEMM_WIDTHS[0]
    if m <= _GEMM_SMALL_M:
        return -(-m // 64), 64
    groups = -(-m // _GEMM_WIDTHS[-1])
    per = -(-m // groups)
    return groups, next(w for w in _GEMM_WIDTHS if w >= per)


def gemm_split_k(tiles: int, k: int, sms: int) -> int:
    """K splits of the Hopper GEMM: as many as fill the card's SMs in one
    wave (one block an SM), each at least _GEMM_MIN_SPLIT_K deep, at most
    _GEMM_MAX_SPLIT (the last split reads every other's partial). Above
    one split, tiles x splits <= sms."""
    return max(1, min(sms // tiles, k // _GEMM_MIN_SPLIT_K, _GEMM_MAX_SPLIT))


@functools.lru_cache(maxsize=None)
def _gemm_plan(m: int, n: int, k: int, sms: int):
    """(row-group width, K splits) of the Hopper GEMM at m x k x n."""
    groups, width = gemm_groups(m)
    return width, gemm_split_k(groups * -(-n // _GEMM_COLS), k, sms)


# (device, stream) -> the Hopper GEMM's split workspace and tile counters, and their pointers
_workspaces: dict = {}


def _gemm_workspace(dev, stream: int):
    """Pointers to the Hopper GEMM's split workspace and tile counters,
    allocated once per device and stream: a split K means tiles x splits <=
    SMs (``gemm_split_k``), so SMs slots of the widest tile's partial and
    SMs counters always do. The counters start at 0 and every launch
    leaves them 0; launches on one stream run in order, and a launch on
    another stream gets its own."""
    key = (dev, stream)
    if key not in _workspaces:
        sms = _sms(dev)
        ws = torch.empty(sms * _GEMM_WIDTHS[-1] // 2 * _GEMM_CONSUMERS, dtype=torch.int32, device=dev)
        counters = torch.zeros(sms, dtype=torch.int32, device=dev)
        _workspaces[key] = (ws, counters, ws.data_ptr(), counters.data_ptr())
    return _workspaces[key][2:]


def _tma_rows(x):
    """(tensor, pointer, row stride in bytes) of ``x`` itself when its rows
    start 16 bytes apart at a 16-byte aligned pointer (what a TMA tensor map
    takes), else of a copy in such storage (a layout copy: the same
    values)."""
    s0, s1 = x.stride()
    p = x.data_ptr()
    if s1 == 1 and s0 % 16 == 0 and p % 16 == 0:
        return x, p, s0
    rows, cols = x.shape
    out = torch.empty((rows, -(-cols // 16) * 16), dtype=x.dtype, device=x.device)[:, :cols]
    out.copy_(x)
    return out, out.data_ptr(), out.stride(0)


def _gemm_sm90(a, b):
    dev = a.device
    M, K, N = _gemm_shape(a, b)
    a, pa, lda = _tma_rows(a)
    b, pb, ldb = _tma_rows(b)
    n, ksplit = _gemm_plan(M, N, K, _sms(dev))
    stream = cuda.stream_handle(dev)
    ws, counters = _gemm_workspace(dev, stream)
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    code = cuda.kernel("int_gemm_sm90")(
        pa, lda, pb, ldb, out.data_ptr(), M, N, K, _GEMM_TYPES[a.dtype], ksplit, n, ws, counters, stream,
    )
    cuda.check(code, "int_gemm_sm90")
    cuda.LAUNCHES["int_gemm_sm90"] += 1
    return out


def _gemm_operands(a, b):
    if a.dtype != b.dtype or a.dtype not in _GEMM_TYPES:
        raise ValueError(f"int_gemm: int8 or uint8 operands expected, got {a.dtype} and {b.dtype}")


def int_gemm(a, b):
    """Kernel C, instances s8 and u8: a [M, K] @ b [K, N] -> int32 [M, N]
    (both int8 or both uint8), on the card the Hopper GEMM
    (``int_gemm_sm90_kernel.cu``)."""
    _gemm_operands(a, b)
    if a.device.type == "cpu":
        return int_gemm_plain(a, b)
    return _gemm_sm90(a, b)


def int_gemm_mma(a, b):
    """``int_gemm``'s function on kernel C's first design
    (``int_gemm_kernel.cu``, mma.sync): the Hopper GEMM's in-call baseline,
    launched by no path."""
    _gemm_operands(a, b)
    if a.device.type == "cpu":
        return int_gemm_plain(a, b)
    return _gemm_kernel(a, b, _GEMM_TYPES[a.dtype], torch.int32)


def _bf16_operands(a, b):
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise ValueError("bf16_gemm: uint8 operands expected")
    K = _gemm_shape(a, b)[1]
    if K > BF16_K_MAX:
        raise ValueError(f"bf16_gemm: K = {K} > {BF16_K_MAX}: float32 sums of u8 products are exact only "
                         f"below 2^24")


def _byte_rows(x):
    """(x, or a contiguous copy where its rows are not contiguous bytes, and
    its row stride in bytes): what the bf16 launcher takes (unit stride
    along a row, rows at least a row apart). A stride along a dimension of
    size 1 is never read, so such a view is passed as it is."""
    rows, cols = x.shape
    if (cols > 1 and x.stride(1) != 1) or (rows > 1 and x.stride(0) < cols):
        x = x.contiguous()
    return x, (x.stride(0) if rows > 1 else cols)


def _bf16_sm90(a, b):
    """The bf16 instance on Hopper (``bf16_gemm_sm90_kernel.cu``), one
    launch; an empty product (M, K or N 0) is zeros without one."""
    dev = a.device
    M, K, N = _gemm_shape(a, b)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0 or K == 0:
        return out.zero_()
    (a, lda), (b, ldb) = _byte_rows(a), _byte_rows(b)
    code = cuda.kernel("bf16_gemm_sm90")(
        a.data_ptr(), lda, b.data_ptr(), ldb, out.data_ptr(), M, N, K, cuda.stream_handle(dev),
    )
    cuda.check(code, "bf16_gemm_sm90")
    cuda.LAUNCHES["bf16_gemm_sm90"] += 1
    return out


def bf16_gemm(a, b):
    """Kernel C, instance bf16: uint8 a [M, K] @ b [K, N], the values taken
    as bf16, summed in float32 -> float32 [M, N], equal to
    ``bf16_gemm_plain``; K <= BF16_K_MAX (else ValueError, on every
    device). On the card the Hopper kernel (``bf16_gemm_sm90_kernel.cu``)."""
    _bf16_operands(a, b)
    if a.device.type == "cpu":
        return bf16_gemm_plain(a, b)
    return _bf16_sm90(a, b)


def bf16_gemm_mma(a, b):
    """``bf16_gemm``'s function on kernel C's first design
    (``int_gemm_kernel.cu``, mma.sync): the Hopper kernel's in-call
    baseline, launched by no path."""
    _bf16_operands(a, b)
    if a.device.type == "cpu":
        return bf16_gemm_plain(a, b)
    return _gemm_kernel(a, b, 2, torch.float32)


# ---------------------------------------------------------------------------
# relayouts
# ---------------------------------------------------------------------------


def bitcast_u8(x):
    """u32 words [R, W] (int32) -> their little-endian bytes [R, 4 W] uint8;
    on the card kernel D's vector copy (``probe_kernels.cu``)."""
    if x.device.type == "cpu":
        return x.contiguous().view(torch.uint8)
    return _bitcast(x, "bitcast")


def bitcast_u8_v1(x):
    """``bitcast_u8`` on kernel D's first design (a thread per word, four
    byte stores): the vector copy's in-call baseline, launched by no path."""
    if x.device.type == "cpu":
        return x.contiguous().view(torch.uint8)
    return _bitcast(x, "bitcast_v1")


def _bitcast(x, kernel: str):
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("bitcast_u8: a contiguous int32 tensor expected")
    if x.data_ptr() % 16:
        raise ValueError("bitcast_u8: the tensor's data must be 16-byte aligned")
    out = torch.empty(x.shape[:-1] + (4 * x.shape[-1],), dtype=torch.uint8, device=x.device)
    code = cuda.kernel(kernel)(x.data_ptr(), x.numel(), out.data_ptr(), cuda.stream_handle(x.device))
    cuda.check(code, kernel)
    cuda.LAUNCHES[kernel] += 1
    return out


def merge_minor(y):
    """[R, X, NL] u32 words (int32) -> [R, X NL]; on the card kernel D's
    vector copy (``probe_kernels.cu``)."""
    R, X, NL = y.shape
    if y.device.type == "cpu":
        return y.reshape(R, X * NL).clone()
    return _merge(y, "merge")


def merge_minor_v1(y):
    """``merge_minor`` on kernel D's first design (a thread per word, its
    indices by division): the vector copy's in-call baseline, launched by no
    path."""
    R, X, NL = y.shape
    if y.device.type == "cpu":
        return y.reshape(R, X * NL).clone()
    return _merge(y, "merge_v1")


def _merge(y, kernel: str):
    R, X, NL = y.shape
    if y.dtype != torch.int32 or not y.is_contiguous():
        raise ValueError("merge_minor: a contiguous int32 tensor expected")
    if y.data_ptr() % 16:
        raise ValueError("merge_minor: the tensor's data must be 16-byte aligned")
    out = torch.empty((R, X * NL), dtype=torch.int32, device=y.device)
    code = cuda.kernel(kernel)(y.data_ptr(), R, X, NL, out.data_ptr(), cuda.stream_handle(y.device))
    cuda.check(code, kernel)
    cuda.LAUNCHES[kernel] += 1
    return out
