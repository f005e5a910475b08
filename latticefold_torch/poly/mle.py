"""MLE engine on tensors.

Evaluation tables of multilinear extensions over the ring, stored as
``[N, ncomp, e, nl]`` (or stacked ``[nm, N, ...]``) Montgomery limbs. Index
bit 0 of the hypercube axis is variable 0, as in the JAX package and the
reference's ``fix_variables``/``build_eq_x_r``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import modops as mo
from ..device import resolve
from ..rings import ops as rops
from ..rings.construct import Ring


def _hyper_axis(mles) -> int:
    return mles.ndim - 4  # [..., N, ncomp, e, nl]


def _even_odd(t, ax: int):
    lead = (slice(None),) * ax
    return t[lead + (slice(0, None, 2),)], t[lead + (slice(1, None, 2),)]


def fold(ring: Ring, mles, c):
    """Fix variable 0 to the diagonal K element ``c`` [e, nl]:
    out[j] = (1-c)*mle[2j] + c*mle[2j+1]  (the (1-r)/r low-bit fold)."""
    a0, a1 = _even_odd(mles, _hyper_axis(mles))
    return rops.ring_add(ring, a0, rops.scalar_mul(ring, rops.ring_sub(ring, a1, a0), c))


def evaluate(ring: Ring, mles, rs):
    """Evaluate at point ``rs`` [nvars, e, nl] (diagonal K coords).

    ``mles``: [..., 2^nvars, ncomp, e, nl] -> [..., ncomp, e, nl].
    """
    cur = mles
    for i in range(rs.shape[0]):
        cur = fold(ring, cur, rs[i])
    return cur.squeeze(_hyper_axis(cur))


def build_eq(ring: Ring, rs):
    """eq(x, r) evaluation table [2^nvars, ncomp, e, nl] for ``rs`` [nvars, e, nl]
    (the doubling recursion of build_eq_x_r_vec: index bit i is r_i)."""
    buf = _one_elt(ring, rs.device)[None]  # [1, ncomp, e, nl]
    for i in range(rs.shape[0] - 1, -1, -1):
        t = rops.scalar_mul(ring, buf, rs[i])
        both = torch.stack([rops.ring_sub(ring, buf, t), t], dim=1)
        buf = both.reshape((-1,) + tuple(buf.shape[1:]))
    return buf


@functools.lru_cache(maxsize=None)
def _one_elt(ring: Ring, device: torch.device):
    R = 1 << (32 * ring.nl)
    vals = np.zeros((ring.ncomp, ring.e), dtype=object)
    vals[:, 0] = R % ring.q  # Montgomery one in every component
    return torch.from_numpy(ring.fq.encode(vals).astype(np.int64)).to(device)


def expand_subfield(ring: Ring, t):
    """Subfield-compact table [..., ncomp, nl] -> full K form [..., ncomp, e, nl]
    (value at K-coordinate 0, zeros elsewhere)."""
    out = torch.zeros(t.shape[:-1] + (ring.e, t.shape[-1]), dtype=t.dtype, device=t.device)
    out[..., 0, :] = t
    return out


def evaluate_subfield(ring: Ring, tables, rs):
    """Evaluate subfield-compact MLEs [..., 2^nvars, ncomp, nl] at a K point.
    The first fold multiplies subfield values by K challenges, so the result
    is K-valued; expansion happens on the fly."""
    if rs.shape[0] == 0:
        return expand_subfield(ring, tables).squeeze(-4)
    a0, a1 = _even_odd(tables, tables.ndim - 3)  # [..., N, ncomp, nl]
    diff = mo.sub(ring.fq, a1, a0)
    # subfield x K: coordinate t of the product is diff * c_t
    prod = mo.mont_mul(ring.fq, diff[..., None, :], rs[0])
    first = mo.add(ring.fq, expand_subfield(ring, a0), prod)
    return evaluate(ring, first, rs[1:])


def pad_to(ring: Ring, mle, n: int):
    """Zero-pad the hypercube axis up to length n (power of two)."""
    ax = _hyper_axis(mle)
    cur = mle.shape[ax]
    if cur == n:
        return mle
    shape = list(mle.shape)
    shape[ax] = n - cur
    return torch.cat([mle, mle.new_zeros(shape)], dim=ax)


def point_to_device(ring: Ring, rs, device=None) -> torch.Tensor:
    """List of K elements -> [nvars, e, nl] Montgomery tensor on ``device``
    (None means CUDA)."""
    device = resolve(device)
    if not rs:
        return torch.zeros((0, ring.e, ring.nl), dtype=torch.int64, device=device)
    R = 1 << (32 * ring.nl)
    vals = np.array([[v * R % ring.q for v in r] for r in rs], dtype=object)
    return torch.from_numpy(ring.fq.encode(vals).astype(np.int64)).to(device)
