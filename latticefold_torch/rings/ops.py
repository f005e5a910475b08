"""Batched ring operations on tensors.

Array convention (the JAX package's): an array of ring elements in NTT form
is ``[..., ncomp, e, nl]`` (Montgomery limbs, held in int64 -- see
``modops``). Coefficient-form arrays are ``[..., d, nl]``. The flat
K-coordinate order (component-major, then extension coordinate) matches
``Ring.flatten`` on the host side and the transcript's absorb order.

``crt``/``icrt`` on a CUDA tensor launch the hand-written kernel
``csrc/crt_kernel.cu`` for every batch size; on a CPU tensor they run the
plain version ``mat_apply`` beside it. Nothing falls back from one to the
other.
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


def _transform_kernel(ring: Ring, which: str, x):
    """Launch csrc/crt_kernel.cu on x [N, d, nl] (CUDA) -> [N, d, nl]."""
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


def _transform(ring: Ring, which: str, x):
    """[..., d, nl] -> [..., d, nl] through the CRT/ICRT matrix."""
    if x.device.type == "cpu":
        return mat_apply(ring.fq, _device_mat(ring, which, x.device), x)
    flat = x.reshape(-1, ring.d, ring.nl).contiguous()
    return _transform_kernel(ring, which, flat).reshape(x.shape)


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
