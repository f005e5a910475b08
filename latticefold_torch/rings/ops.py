"""Batched ring operations on tensors.

Array convention (the JAX package's): an array of ring elements in NTT form
is ``[..., ncomp, e, nl]`` (Montgomery limbs, held in int64 -- see
``modops``). Coefficient-form arrays are ``[..., d, nl]``. The flat
K-coordinate order (component-major, then extension coordinate) matches
``Ring.flatten`` on the host side and the transcript's absorb order.

``crt``/``icrt`` on a CUDA tensor launch the hand-written tensor-core
kernel ``csrc/crt_tc_kernel.cu`` for every batch size; on a CPU tensor they
run the plain version ``mat_apply``. Nothing falls back from one to the
other. ``crt_conv_plain`` is the tensor-core kernel's own plain version (the
same conv-folded byte matrix it reads), and ``csrc/crt_kernel.cu`` (32-bit
multiply-adds on CUDA cores) the earlier kernel, kept as its in-call
baseline: no path of the package launches it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import cuda
from .. import modops as mo
from ..device import resolve
from .construct import Ring


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int64)).to(device)


# ---------------------------------------------------------------------------
# CRT / ICRT: a constant d x d F_q matrix applied to every element
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _device_mat(ring: Ring, which: str, device: torch.device) -> torch.Tensor:
    """[dout, din, nl] Montgomery matrix (row = output) on ``device``."""
    return _tensor(ring.np_matrix(which, mont=True), device)


def mat_apply(m: mo.Modulus, M, x):
    """Plain version of the CRT kernel. ``M``: [dout, din, nl] Montgomery,
    ``x``: [..., din, nl] -> [..., dout, nl]; out[o] = sum_i M[o, i] x[i] R^-1.
    All (element, output, input) products at once, then a modular tree sum
    over the input axis."""
    prod = mo.mont_mul(m, x[..., None, :, :], M)  # [..., dout, din, nl]
    return mo.sum_mod(m, prod, -2)


def _transform_simt(ring: Ring, which: str, x):
    """Launch csrc/crt_kernel.cu (the SIMT baseline) on x [N, d, nl] (CUDA)
    -> [N, d, nl]."""
    dev = x.device
    mat = _device_mat(ring, which, dev)
    cuda.require_tensor(x, "crt input", dev)
    out = torch.empty_like(x)
    fn = cuda.kernel("crt")
    code = fn(
        x.data_ptr(), mat.data_ptr(), out.data_ptr(), x.shape[0], ring.d, ring.nl,
        cuda.field_constants(ring.q, ring.nl), cuda.stream_handle(dev),
    )
    cuda.check(code, "crt")
    cuda.LAUNCHES["crt"] += 1
    return out


# The tensor-core CRT (csrc/crt_tc_kernel.cu; the TPU kernel's route,
# latticefold_tpu/rings/pallas_crt.py): the matrix, prescaled by 2^32 R mod
# q, split into bytes and folded over byte positions into one u8 matrix C,
# so that for x's bytes xb the s32 sums Y[(o, s)] = sum_k xb[k] C[k, (o, s)]
# are output o's byte-position sums; a base-256 carry and a wide Montgomery
# reduction by 2^(32 (nl + 1)) give the Montgomery limbs of sum_i M[o, i] x[i]
# R^-1. Every sum has at most 4 d nl <= 512 terms below 2^16: exact in s32.

TC_COLS = 128  # columns of one chunk of C: the kernel's wgmma N
TC_KB = 128  # k per 128-byte row of a chunk's k block


@functools.lru_cache(maxsize=None)
def conv_matrix(ring: Ring, which: str) -> np.ndarray:
    """C as uint8 [K, d, 8 nl], K = 4 d nl. Row k = 4 (i nl + l) + b is byte
    b of limb l of input i (so four consecutive k are one u32 limb);
    column (o, s) is byte position s of output o, s < 8 nl (s = 8 nl - 1 is
    all zero). For a fixed row only one byte of each entry M[o, i] 2^32 R
    mod q lands on a position, so every entry is one byte."""
    d, nl = ring.d, ring.nl
    rows = {"crt": ring.crt_rows, "icrt": ring.icrt_rows}[which]
    scale = (1 << (32 * nl + 32)) % ring.q
    adj = ring.fq.encode(np.array([[v * scale % ring.q for v in row] for row in rows], dtype=object))
    adj_bytes = adj.astype("<u4").view(np.uint8).reshape(d, d, 4 * nl)  # [o, i, byte]
    C = np.zeros((d, 4 * nl, d, 8 * nl), dtype=np.uint8)  # [i, 4 l + b, o, s]
    for j in range(4 * nl):
        C[:, j, :, j : j + 4 * nl] = adj_bytes.transpose(1, 0, 2)
    return C.reshape(4 * d * nl, d, 8 * nl)


def conv_tiles(ring: Ring, which: str) -> np.ndarray:
    """``conv_matrix`` in the layout the kernel copies into shared memory:
    uint8 [chunks, k blocks, TC_COLS, TC_KB]. A chunk holds the columns of
    TC_COLS / (8 nl) outputs (outputs past d are zero), a k block 128 k (k
    past K zero), each column's 128 bytes one row, K-major as 8-bit wgmma
    reads B, in the 128-byte swizzle: 16-byte group g of row n lies at
    g ^ (n % 8) (csrc/crt_tc.cuh ``conv_offset``)."""
    C = conv_matrix(ring, which)
    K, d, sp = C.shape
    cpc = TC_COLS // sp
    nch, nkb = -(-d // cpc), -(-K // TC_KB)
    padded = np.zeros((nkb * TC_KB, nch * cpc, sp), dtype=np.uint8)
    padded[:K, :d] = C
    tiles = padded.reshape(nkb, TC_KB, nch, TC_COLS).transpose(2, 0, 3, 1)  # [ch, kb, n, k]
    n = np.arange(TC_COLS)[:, None]
    k = np.arange(TC_KB)[None, :]
    out = np.empty_like(tiles)
    out[:, :, n, k ^ ((n & 7) << 4)] = tiles
    return out


@functools.lru_cache(maxsize=None)
def _device_conv(ring: Ring, which: str, device: torch.device):
    """(``conv_matrix``, ``conv_tiles``) as uint8 tensors on ``device``."""
    return (torch.from_numpy(conv_matrix(ring, which)).to(device),
            torch.from_numpy(np.ascontiguousarray(conv_tiles(ring, which))).to(device))


def crt_conv_plain(ring: Ring, which: str, x):
    """Plain version of the tensor-core kernel, on the matrix it reads:
    x [..., d, nl] Montgomery -> [..., d, nl]. The byte dot runs in float64
    (exact: every sum is below 2^25), then ``mxu._carry_pack`` and
    ``mxu._redc_wide``."""
    from . import mxu  # mxu imports this module

    d, nl = ring.d, ring.nl
    C = _device_conv(ring, which, x.device)[0]
    xb = mxu.to_planes(x.reshape(-1, d, nl)).reshape(-1, 4 * d * nl)
    y = (xb.double() @ C.reshape(4 * d * nl, d * 8 * nl).double()).long().reshape(-1, d, 8 * nl)
    t = mxu._carry_pack([y[..., s] for s in range(8 * nl - 1)], 2 * nl + 1)
    return mxu._redc_wide(ring.fq, t).reshape(x.shape)


def _transform_tc(ring: Ring, which: str, x):
    """Launch csrc/crt_tc_kernel.cu on x [N, d, nl] (CUDA) -> [N, d, nl]. A
    (nl, d) without an instance there makes the launcher return an error
    code, which ``cuda.check`` raises."""
    dev = x.device
    tiles = _device_conv(ring, which, dev)[1]
    cuda.require_tensor(x, "crt input", dev)
    out = torch.empty_like(x)
    code = cuda.kernel("crt_tc")(
        x.data_ptr(), tiles.data_ptr(), out.data_ptr(), x.shape[0], ring.d, ring.nl,
        cuda.field_constants(ring.q, ring.nl), cuda.stream_handle(dev),
    )
    cuda.check(code, "crt_tc")
    cuda.LAUNCHES["crt_tc"] += 1
    return out


def _transform(ring: Ring, which: str, x):
    """[..., d, nl] -> [..., d, nl] through the CRT/ICRT matrix."""
    if x.device.type == "cpu":
        return mat_apply(ring.fq, _device_mat(ring, which, x.device), x)
    flat = x.reshape(-1, ring.d, ring.nl).contiguous()
    return _transform_tc(ring, which, flat).reshape(x.shape)


def crt(ring: Ring, coeffs):
    """[..., d, nl] coefficient form -> [..., ncomp, e, nl] NTT form."""
    flat = _transform(ring, "crt", coeffs)
    return flat.reshape(flat.shape[:-2] + (ring.ncomp, ring.e, ring.nl))


def icrt(ring: Ring, x):
    """[..., ncomp, e, nl] NTT form -> [..., d, nl] coefficient form."""
    flat = x.reshape(x.shape[:-3] + (ring.d, ring.nl))
    return _transform(ring, "icrt", flat)


# ---------------------------------------------------------------------------
# K (extension field) and ring multiplication
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _red_rows_np(ring: Ring):
    """[e-1, e, nl] Montgomery coords of y^(e+k) mod m(y) (numpy constant)."""
    if ring.e == 1:
        return None
    R = 1 << (32 * ring.nl)
    rows = [[v * R % ring.q for v in row] for row in ring.K.red_rows]
    return ring.fq.encode(np.array(rows, dtype=object))


@functools.lru_cache(maxsize=None)
def red_rows(ring: Ring, device: torch.device):
    rows = _red_rows_np(ring)
    return None if rows is None else _tensor(rows, device)


def ext_mul(ring: Ring, a, b):
    """Pairwise K multiplication; a, b: [..., e, nl] (broadcastable)."""
    m, e = ring.fq, ring.e
    if e == 1:
        return mo.mont_mul(m, a, b)
    conv = [None] * (2 * e - 1)
    for i in range(e):
        p = mo.mont_mul(m, a[..., i : i + 1, :], b)  # [..., e, nl]
        for j in range(e):
            t = p[..., j, :]
            conv[i + j] = t if conv[i + j] is None else mo.add(m, conv[i + j], t)
    out = conv[:e]
    red = red_rows(ring, a.device)
    for k in range(e - 1):
        term = mo.mont_mul(m, conv[e + k][..., None, :], red[k])  # [..., e, nl]
        for t in range(e):
            out[t] = mo.add(m, out[t], term[..., t, :])
    return torch.stack(out, dim=-2)


def ring_mul(ring: Ring, a, b):
    """Componentwise ring product; a, b: [..., ncomp, e, nl]."""
    return ext_mul(ring, a, b)


def scalar_mul(ring: Ring, a, k):
    """Multiply ring array ``a`` [..., ncomp, e, nl] by diagonal K element ``k`` [e, nl]."""
    return ext_mul(ring, a, k)


def const_mul(ring: Ring, a, c):
    """Multiply by an F_q constant ``c`` [nl] (diagonal, subfield)."""
    return mo.mont_mul(ring.fq, a, c)


def ring_add(ring: Ring, a, b):
    return mo.add(ring.fq, a, b)


def ring_sub(ring: Ring, a, b):
    return mo.sub(ring.fq, a, b)


def ring_sum(ring: Ring, a, axis: int):
    return mo.sum_mod(ring.fq, a, axis)


# ---------------------------------------------------------------------------
# host <-> device conversion of ring element arrays
# ---------------------------------------------------------------------------


def to_device(ring: Ring, elts, device=None) -> torch.Tensor:
    """Host NTT-form element(s) -> [..., ncomp, e, nl] Montgomery limbs.

    ``elts`` is a single ring element (tuple of ncomp K-tuples) or arbitrarily
    nested *lists* of them. ``device``: None means CUDA (raises without a card).
    """
    dev = resolve(device)

    def shape_of(x):
        return () if isinstance(x, tuple) else (len(x),) + shape_of(x[0])

    shp = shape_of(elts)
    out = np.empty(shp + (ring.ncomp, ring.e), dtype=object)

    def fill(idx, x):
        if isinstance(x, tuple):
            for c in range(ring.ncomp):
                for t in range(ring.e):
                    out[idx + (c, t)] = x[c][t]
        else:
            for i, xi in enumerate(x):
                fill(idx + (i,), xi)

    fill((), elts)
    R = 1 << (32 * ring.nl)
    mont = np.vectorize(lambda v: int(v) * R % ring.q, otypes=[object])(out)
    return _tensor(ring.fq.encode(mont), dev)


def to_host(ring: Ring, arr) -> np.ndarray:
    """[..., ncomp, e, nl] mont tensor -> object array of host ring elements."""
    can = mo.from_mont(ring.fq, arr).cpu().numpy()
    ints = ring.fq.decode(can)  # [..., ncomp, e] object ints
    shape = ints.shape[:-2]
    flat = ints.reshape((-1, ring.ncomp, ring.e))
    out = np.empty(flat.shape[0], dtype=object)
    for i in range(flat.shape[0]):
        out[i] = tuple(tuple(int(flat[i, c, t]) for t in range(ring.e)) for c in range(ring.ncomp))
    return out.reshape(shape) if shape else out[0]


def k_to_device(ring: Ring, kelt, device=None) -> torch.Tensor:
    """Host K element (tuple of e ints) -> [e, nl] Montgomery limbs."""
    R = 1 << (32 * ring.nl)
    vals = np.array([v * R % ring.q for v in kelt], dtype=object)
    return _tensor(ring.fq.encode(vals), resolve(device))


def diag_to_device(ring: Ring, kelt, device=None) -> torch.Tensor:
    """Host K element -> diagonal ring element [ncomp, e, nl]."""
    k = k_to_device(ring, kelt, device)
    return k.expand((ring.ncomp,) + tuple(k.shape)).contiguous()
