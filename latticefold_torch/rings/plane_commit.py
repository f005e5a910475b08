"""The byte-plane batch commit: the counterpart of the JAX package's fused
Pallas commit, ``latticefold_tpu/rings/pallas_commit.py``.

The same function as ``mxu.ajtai_commit_cm``, with the lhs prepared as
there: the Ajtai matrix, premultiplied by 2^32 mod q, split into byte planes
XOR 0x80 (signed int8, row r = (kappa e index) 4 nl + limb 4 + byte), rows
padded to a multiple of 32 with one all-ones row at ``rows`` that gives the
witness column sums, and per-slice row sums ``sM``. The contraction over n
runs in slices of at most ``_K_SLICE`` terms:

  1. ``plane_dot`` (kernel A; the port of ``_fused_slice`` /
     ``_dot_kernel``): per slice and component, P[m, byte L + word] =
     sum_k A_i8[m, k] * (int8)(byte of (W[k, word] ^ 0x80808080)), the
     witness planes built in registers from the u32 words, never in device
     memory. The dot runs on ``csrc/plane_dot_sm90_kernel.cu`` (wgmma on
     TMA-loaded stages, every Ajtai row per block), as do the probes' K-major
     lhs (each stage transposed in shared memory) and dot-only mode;
     ``planes_only`` runs on ``csrc/plane_dot_kernel.cu`` (mma.sync), which
     ``plane_dot_mma`` also reaches in the other modes: the Hopper dot's
     in-call baseline, launched by no path.
  2. ``epilogue`` (kernel B, ``csrc/plane_epilogue_diag_kernel.cu``; the
     port of ``_epilogue_fused`` and ``mxu._ext_fold``): the unsigned-plane
     corrections P + 128 colsum + 128 rowsum + 128^2 ks of every slice, the
     plane pairs grouped by byte position, the base-256 carry, the wide
     reduction by R2 = 2^(32 (nl + 1)) and the fold of y^(e+k) with m(y),
     to [kappa, Nb, ncomp, e, nl] Montgomery limbs. A warp lane sums one
     wrapped diagonal of a patch of plane products; ``epilogue_items``
     reaches the first port (``csrc/plane_epilogue_kernel.cu``, a thread
     per plane-pair item), the kernel's in-call baseline, which no path
     launches.

On CUDA tensors the wrappers launch the kernels; on CPU tensors they run the
plain versions beside them. Nothing falls back from one to the other, and an
(nl, e) or mode without a kernel instance raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import cuda
from .. import modops as mo
from . import mxu, ops
from .construct import Ring

_K_SLICE = 1 << 15  # 255^2 * 2^15 < 2^31: exact int32 sums per slice
MODES = {"full": 0, "planes_only": 1, "dot_only": 2}
_BLOCKS_PER_SM = 8  # blocks to aim for on each SM (K splits make up the rest)
_MIN_SPLIT_K = 256  # the least K a split takes
_SM90_WIDTHS = (64, 128, 192, 224)  # the Hopper dot's row-group widths N
_SM90_MIN_SPLIT_K = 1024  # the least K a split of the Hopper dot takes
_SM90_WORDS = 32  # the words a block of the Hopper dot owns (csrc: Cfg::WT)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class FusedPlanes(NamedTuple):
    lhs_i8: torch.Tensor  # [c, Mpad, n] int8 signed matrix planes (+ ones row)
    sM: torch.Tensor  # [c, n_slices, Mpad] int32 per-slice row sums
    rows: int  # true (unpadded) row count = kappa * e * 4 nl


def precompute(ring: Ring, matrix) -> FusedPlanes:
    """Montgomery Ajtai matrix [kappa, n, ncomp, e, nl] -> FusedPlanes, built
    on the matrix's device."""
    planes = mxu.ajtai_precompute(ring, matrix)  # [c, kappa e, n, 4 nl] uint8
    c, ke, n, da = planes.shape
    rows = ke * da
    mpad = _round_up(rows + 1, 32)  # always one spare row for the ones row
    # rows of n padded to 16 bytes in storage: the Hopper dot's tensor map
    # needs 16-byte row strides
    lhs = torch.zeros((c, mpad, _round_up(n, 16)), dtype=torch.int8, device=planes.device)[:, :, :n]
    lhs[:, :rows] = (planes.movedim(-1, -2).reshape(c, rows, n) ^ 0x80).view(torch.int8)
    lhs[:, rows] = 1
    sM = torch.stack([lhs[:, :, k0 : k0 + _K_SLICE].sum(-1, dtype=torch.int32)
                      for k0 in range(0, n, _K_SLICE)], dim=1)
    return FusedPlanes(lhs, sM, rows)


# ---------------------------------------------------------------------------
# kernel A: the signed byte-plane dot of one slice
# ---------------------------------------------------------------------------


def _signed_planes(w, mode: str):
    """w [c, K, L] (u32 words in int32 or int64 lanes) -> the int8 plane
    values [c, K, 4 L] as int64, column = byte L + word. ``dot_only``: the
    probe's fake planes, the low byte of each word (no XOR) for every byte."""
    wu = w.long() & mo.MASK32
    if mode == "dot_only":
        parts = [wu & 0xFF] * 4
    else:
        x = wu ^ 0x80808080
        parts = [(x >> (8 * b)) & 0xFF for b in range(4)]
    return torch.cat(parts, dim=-1).to(torch.uint8).view(torch.int8).long()


def plane_dot_plain(lhs, w, mode: str = "full", kmajor: bool = False):
    """Plain version of ``plane_dot``. The dot runs in float64, exact: every
    sum is below 2^53 (|A| <= 128, |plane| <= 128, K <= 2^15 per slice)."""
    pi = _signed_planes(w, mode)
    c, K, N = pi.shape
    mpad = lhs.shape[2] if kmajor else lhs.shape[1]
    if mode == "planes_only":
        out = torch.zeros((c, mpad, N), dtype=torch.int32, device=pi.device)
        out[:, 0] = pi.sum(1).to(torch.int32)
        return out
    a = lhs.transpose(1, 2) if kmajor else lhs
    return torch.matmul(a.double(), pi.double()).to(torch.int32)


def split_k(tiles: int, ks: int, sms: int) -> int:
    """How many K splits a grid of ``tiles`` blocks per split takes (kernels
    A and C): enough blocks for _BLOCKS_PER_SM on every SM, each split at
    least _MIN_SPLIT_K deep."""
    return max(1, min(-(-_BLOCKS_PER_SM * sms // tiles), ks // _MIN_SPLIT_K))


def sm90_groups(mpad: int):
    """The Hopper dot's row groups for ``mpad`` rows: (groups, N), the
    fewest groups of at most 224 rows that cover Mpad, N the least
    instantiated width that holds an equal share (Mpad 224: one group of
    224; 416: two of 224; 576: three of 192). A block owns one group and
    ``_SM90_WORDS`` words."""
    groups = -(-mpad // _SM90_WIDTHS[-1])
    per = -(-mpad // groups)
    return groups, next(w for w in _SM90_WIDTHS if w >= per)


def split_k_sm90(tiles: int, ks: int, sms: int) -> int:
    """K splits of the Hopper dot: one block per SM (its stage ring takes
    most of the shared memory), so as many splits as fit the card's SMs in
    one wave, each at least _SM90_MIN_SPLIT_K deep."""
    return max(1, min(sms // tiles, ks // _SM90_MIN_SPLIT_K))


def _aligned16(t) -> bool:
    """Pointer and the strides of dims 0 and 1 multiples of 16 bytes: what a
    TMA tensor map takes."""
    e = t.element_size()
    return t.data_ptr() % 16 == 0 and (t.stride(0) * e) % 16 == 0 and (t.stride(1) * e) % 16 == 0


def _plane_dot_sm90(lhs, w, mode: str = "full", kmajor: bool = False):
    dev = w.device
    if lhs.device != dev or lhs.dtype != torch.int8 or lhs.stride(-1) != 1:
        raise ValueError("plane_dot: lhs must be an int8 tensor on the witness's device with unit last stride")
    if w.dtype not in (torch.int32, torch.int64) or w.stride(-1) != 1:
        raise ValueError("plane_dot: w must hold u32 words in int32 or int64 lanes, unit last stride")
    c, ks, L = w.shape
    mpad = lhs.shape[2] if kmajor else lhs.shape[1]
    if lhs.shape[0] != c or (lhs.shape[1] if kmajor else lhs.shape[2]) != ks:
        raise ValueError(f"plane_dot: lhs {tuple(lhs.shape)} does not fit w {tuple(w.shape)}")
    groups, n = sm90_groups(mpad)
    if not (_aligned16(lhs) and _aligned16(w)):
        raise ValueError("plane_dot: the Hopper dot's tensor maps need 16-byte aligned pointers and row "
                         f"strides: lhs strides {lhs.stride()}, w strides {w.stride()} of "
                         f"{w.element_size()}-byte words (``empty_batch`` pads a witness batch's rows)")
    tiles = c * groups * -(-L // _SM90_WORDS)
    ksplit = split_k_sm90(tiles, ks, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = (torch.zeros if ksplit > 1 else torch.empty)((c, mpad, 4 * L), dtype=torch.int32, device=dev)
    code = cuda.kernel("plane_dot_sm90")(
        lhs.data_ptr(), lhs.stride(0), lhs.stride(1), w.data_ptr(), w.stride(0),
        w.stride(1), w.element_size(), out.data_ptr(), c, mpad, ks, L, ksplit, n, MODES[mode],
        int(kmajor), cuda.stream_handle(dev),
    )
    cuda.check(code, "plane_dot_sm90")
    cuda.LAUNCHES["plane_dot_sm90"] += 1
    return out


def _plane_dot_kernel(lhs, w, mode: str, kmajor: bool):
    dev = w.device
    if lhs.device != dev or lhs.dtype != torch.int8 or lhs.stride(-1) != 1:
        raise ValueError("plane_dot: lhs must be an int8 tensor on the witness's device with unit last stride")
    if w.dtype not in (torch.int32, torch.int64) or w.stride(-1) != 1:
        raise ValueError("plane_dot: w must hold u32 words in int32 or int64 lanes, unit last stride")
    c, ks, L = w.shape
    mpad = lhs.shape[2] if kmajor else lhs.shape[1]
    if lhs.shape[0] != c or (lhs.shape[1] if kmajor else lhs.shape[2]) != ks:
        raise ValueError(f"plane_dot: lhs {tuple(lhs.shape)} does not fit w {tuple(w.shape)}")
    # blocks per split: 64 rows x 16 words, or 32 words for the plane sums
    tiles = c * -(-L // 32) if mode == "planes_only" else c * -(-mpad // 64) * -(-L // 16)
    ksplit = split_k(tiles, ks, torch.cuda.get_device_properties(dev).multi_processor_count)
    zeroed = ksplit > 1 or mode == "planes_only"
    out = (torch.zeros if zeroed else torch.empty)((c, mpad, 4 * L), dtype=torch.int32, device=dev)
    vec = lhs.data_ptr() % 16 == 0 and lhs.stride(0) % 16 == 0 and lhs.stride(1) % 16 == 0
    code = cuda.kernel("plane_dot")(
        lhs.data_ptr(), lhs.stride(0), lhs.stride(1), w.data_ptr(), w.stride(0),
        w.stride(1), w.element_size(), out.data_ptr(), c, mpad, ks, L, MODES[mode],
        int(kmajor), ksplit, int(vec), cuda.stream_handle(dev),
    )
    cuda.check(code, "plane_dot")
    cuda.LAUNCHES["plane_dot"] += 1
    return out


def plane_dot(lhs, w, mode: str = "full", kmajor: bool = False):
    """Kernel A. lhs [c, Mpad, Ks] int8 (``kmajor``: [c, Ks, Mpad]), w
    [c, Ks, L] u32 words (int32 or int64 lanes; strided views along c and
    Ks are taken as they are) -> P [c, Mpad, 4 L] int32, column = byte L +
    word. Modes: ``full`` (the K2 / P1 v2 / P2 batched function, and P3's
    with the K-major lhs), ``dot_only`` (the dot on fake planes, the low
    byte of each word; row-major lhs), both on the Hopper dot
    (``plane_dot_sm90_kernel.cu``), and ``planes_only`` (row 0 = the plane
    column sums, other rows 0) on the mma.sync kernel."""
    if mode not in MODES:
        raise ValueError(f"plane_dot: no mode {mode!r} (modes: {', '.join(MODES)})")
    if w.device.type == "cpu":
        return plane_dot_plain(lhs, w, mode, kmajor)
    if mode == "planes_only":
        return _plane_dot_kernel(lhs, w, mode, kmajor)
    return _plane_dot_sm90(lhs, w, mode, kmajor)


def plane_dot_mma(lhs, w, mode: str = "full", kmajor: bool = False):
    """``plane_dot``'s full and dot-only functions (row-major or, in full
    mode, K-major lhs) on the mma.sync kernel (``plane_dot_kernel.cu``):
    P1's ``kern_v1`` and the Hopper dot's in-call baseline in every mode,
    launched by no path."""
    if mode not in ("full", "dot_only"):
        raise ValueError(f"plane_dot_mma: no mode {mode!r} (full, dot_only)")
    if w.device.type == "cpu":
        return plane_dot_plain(lhs, w, mode, kmajor)
    return _plane_dot_kernel(lhs, w, mode, kmajor)


# ---------------------------------------------------------------------------
# kernel B: corrections, position grouping, carry, wide REDC, extension fold
# ---------------------------------------------------------------------------


def _slice_lengths(n: int):
    return [min(n, k0 + _K_SLICE) - k0 for k0 in range(0, n, _K_SLICE)]


def epilogue_plain(ring: Ring, P, sM, rows: int, n: int, Nb: int):
    """Plain version of ``epilogue``: the JAX package's corrections and XLA
    epilogue (``pallas_commit._commit_fused``), then ``mxu._ext_fold``."""
    nl, e, c = ring.nl, ring.e, ring.ncomp
    da = 4 * nl
    lo = hi = 0
    for si, ks in enumerate(_slice_lengths(n)):
        p = P[si].long()
        pu = p[:, :rows] + 128 * p[:, rows, None, :] + 128 * sM[:, si, :rows, None].long() + 128 * 128 * ks
        lo = lo + (pu & 0xFFFF)
        hi = hi + (pu >> 16)
    # rows ke DA + i (i = limb 4 + byte); columns byte' L + word (o nl + l')
    ke = rows // da
    lo6 = lo.reshape(c, ke, da, 4, e * Nb, nl)
    hi6 = hi.reshape(c, ke, da, 4, e * Nb, nl)
    # [c, ke, DA(i), eNb, DB(j = l' 4 + byte')]: the layout of mxu._plane_dot
    lo5 = lo6.permute(0, 1, 2, 4, 5, 3).reshape(c, ke, da, e * Nb, da)
    hi5 = hi6.permute(0, 1, 2, 4, 5, 3).reshape(c, ke, da, e * Nb, da)
    u = mxu._group_positions(lo5, hi5, da, da)
    Pm = mxu._redc_wide(ring.fq, mxu._carry_pack(u, 2 * nl + 1))  # [c, ke, eNb, nl]
    return mxu._ext_fold(ring, Pm, ke // e, Nb)


def diag_groups(ring: Ring, Nb: int) -> int:
    """b groups a block of kernel B's diagonal kernel takes: a group is the
    32 / (4 nl) consecutive b of one warp task (one b at nl 8), and a block
    takes every (i, j) of its groups' b. Chosen from ``chip_smoke.py``'s
    ``sweep_epilogue_groups`` on the H100 (PERF.md): 8 at nl 8, 4 where Nb
    is 32 or more (bench.py's b64), else 1."""
    if ring.nl == 8:
        return 8
    return 4 if Nb >= 32 else 1


def _epilogue_kernel(kernel: str, ring: Ring, P, sM, rows: int, n: int, Nb: int, *extra):
    dev = P.device
    if P.dtype != torch.int32 or sM.dtype != torch.int32 or sM.device != dev:
        raise ValueError("epilogue: P and sM must be int32 tensors on one device")
    P, sM = P.contiguous(), sM.contiguous()
    nsl, c, mpad, four_l = P.shape
    kappa = rows // (4 * ring.nl * ring.e)
    if (c != ring.ncomp or four_l != 4 * ring.e * Nb * ring.nl or not 0 < rows < mpad
            or nsl != len(_slice_lengths(n)) or tuple(sM.shape) != (c, nsl, mpad)):
        raise ValueError(f"epilogue: P {tuple(P.shape)}, sM {tuple(sM.shape)} do not fit rows={rows}, "
                         f"n={n}, Nb={Nb} of {ring.name}")
    out = torch.empty((kappa, Nb, c, ring.e, ring.nl), dtype=torch.int64, device=dev)
    red = ops.red_rows(ring, dev)
    code = cuda.kernel(kernel)(
        P.data_ptr(), sM.data_ptr(), 0 if red is None else red.data_ptr(), out.data_ptr(),
        nsl, c, mpad, four_l // 4, rows, kappa, Nb, ring.e, ring.nl, n, _K_SLICE, *extra,
        cuda.field_constants(ring.q, ring.nl), cuda.stream_handle(dev),
    )
    cuda.check(code, kernel)
    cuda.LAUNCHES[kernel] += 1
    return out


def epilogue(ring: Ring, P, sM, rows: int, n: int, Nb: int):
    """Kernel B. P [n_slices, c, Mpad, 4 L] int32 (kernel A's output per
    slice), sM [c, n_slices, Mpad] int32 -> [kappa, Nb, c, e, nl] Montgomery
    limbs (int64 lanes); on the card the diagonal kernel,
    ``csrc/plane_epilogue_diag_kernel.cu``."""
    if P.device.type == "cpu":
        return epilogue_plain(ring, P, sM, rows, n, Nb)
    return _epilogue_kernel("plane_epilogue_diag", ring, P, sM, rows, n, Nb, diag_groups(ring, Nb))


def epilogue_items(ring: Ring, P, sM, rows: int, n: int, Nb: int):
    """``epilogue``'s function on kernel B's first port,
    ``csrc/plane_epilogue_kernel.cu`` (a thread per (b, i, j) item): the
    diagonal kernel's in-call baseline, launched by no path."""
    if P.device.type == "cpu":
        return epilogue_plain(ring, P, sM, rows, n, Nb)
    return _epilogue_kernel("plane_epilogue", ring, P, sM, rows, n, Nb)


# ---------------------------------------------------------------------------
# the batch commit
# ---------------------------------------------------------------------------


def empty_batch(ring: Ring, n: int, Nb: int, device) -> torch.Tensor:
    """An uninitialized component-major witness batch [ncomp, n, e, Nb, nl]
    (int64 lanes) whose rows of e Nb nl words start 16 bytes apart, as the
    Hopper dot's tensor map needs: the rows are padded to an even number of
    words in storage (BabyBear's fold batch has 63)."""
    L = ring.e * Nb * ring.nl
    store = torch.empty((ring.ncomp, n, _round_up(L, 2)), dtype=torch.int64, device=device)
    return store[:, :, :L].view(ring.ncomp, n, ring.e, Nb, ring.nl)


def aligned_batch(ring: Ring, fcm) -> torch.Tensor:
    """``fcm`` itself when its rows of e Nb nl words start 16 bytes apart (as
    ``empty_batch``'s do, and as the Hopper dot's tensor map needs), else a
    copy of it in ``empty_batch`` storage: a layout copy, the same values
    (a contiguous batch with an odd word count, such as BabyBear's
    [8, n, 9, Nb, 1] with odd Nb, takes this copy)."""
    c, n, e, Nb, nl = fcm.shape
    try:
        rows = fcm.view(c, n, e * Nb * nl)
    except RuntimeError:  # the row's words are not one strided run
        rows = None
    if rows is not None and rows.stride(-1) == 1 and _aligned16(rows):
        return fcm
    out = empty_batch(ring, n, Nb, fcm.device)
    out.copy_(fcm)
    return out


def ajtai_commit_fused(ring: Ring, pre: FusedPlanes, fcm):
    """The byte-plane batch commit, bit-identical to ``mxu.ajtai_commit_cm``.

    fcm: [ncomp, n, e, Nb, nl] Montgomery component-major witness batch;
    on the card its rows of e Nb nl words must start 16 bytes apart (a
    contiguous batch with an even word count, or ``empty_batch``'s).
    Returns [kappa, Nb, ncomp, e, nl]. One kernel A launch per slice of
    ``_K_SLICE`` terms, then one kernel B launch."""
    c, n, e, Nb, nl = fcm.shape
    w2d = fcm.reshape(c, n, e * Nb * nl)
    Ps = [plane_dot(pre.lhs_i8[:, :, k0 : k0 + _K_SLICE], w2d[:, k0 : k0 + _K_SLICE])
          for k0 in range(0, n, _K_SLICE)]
    P = Ps[0][None] if len(Ps) == 1 else torch.stack(Ps)
    return epilogue(ring, P, pre.sM, pre.rows, n, Nb)


__all__ = ["FusedPlanes", "precompute", "plane_dot", "plane_dot_mma", "epilogue", "epilogue_items", "empty_batch",
           "aligned_batch", "ajtai_commit_fused"]
