"""Scalar-point MLE operations for LatticeFold+.

LF+ sumcheck points are base-field scalars (plus/sumcheck.py), so eq tables
and MLE evaluations are F_q-weighted: eq weights [2^s, nl], applied to scalar
tables [N, nl] or NTT-form ring tables [N, ncomp, e, nl] by plain Montgomery
scaling (no extension arithmetic). Host ints enter as canonical limbs and
are taken to the Montgomery domain on the tensor's device. Evaluations take
the rows a chunk at a time, so their temporaries stay bounded however many
tables are stacked.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import modops as mo
from ..device import resolve
from ..rings.construct import Ring

# F_q values of the MLEs per chunk of an evaluation's rows
_EVAL_VALUES = 1 << 23


def canonical_tensor(ring: Ring, vals, device=None) -> torch.Tensor:
    """Ints (any nesting numpy takes, any sign) -> canonical limbs
    [..., nl] int64 on ``device`` (None: CUDA)."""
    a = np.asarray(vals, dtype=object) % ring.q
    limbs = [((a >> (32 * i)) & 0xFFFFFFFF).astype(np.int64) for i in range(ring.nl)]
    return torch.from_numpy(np.stack(limbs, axis=-1)).to(resolve(device))


def scalar_dev(ring: Ring, v: int, device=None) -> torch.Tensor:
    """F_q int -> Montgomery limbs [nl]."""
    return scalars_dev(ring, [v], device)[0]


def scalars_dev(ring: Ring, vs: Sequence[int], device=None) -> torch.Tensor:
    """F_q ints -> Montgomery limbs [len(vs), nl]."""
    return mo.to_mont(ring.fq, canonical_tensor(ring, list(vs), device))


def host_ints(ring: Ring, dev) -> list:
    """Montgomery limbs [..., nl] -> canonical ints (a flat list)."""
    return [int(v) for v in ring.fq.decode(mo.from_mont(ring.fq, dev).cpu().numpy()).reshape(-1)]


def build_eq_scalar(ring: Ring, rs):
    """tensor(r): [nvars, nl] -> [2^nvars, nl] (index bit i <-> r_i)."""
    m = ring.fq
    buf = torch.from_numpy(m.r1_limbs.astype(np.int64)).to(rs.device)[None]
    for i in range(rs.shape[0] - 1, -1, -1):
        t = mo.mont_mul(m, buf, rs[i][None])
        buf = torch.stack([mo.sub(m, buf, t), t], dim=1).reshape(-1, m.nl)
    return buf


def _eval_rows(ring: Ring, mles, w):
    """sum_x w[x] mles[:, x] over the row axis, _EVAL_VALUES F_q values of
    ``mles`` at a time (modular sums are exact: chunking changes no value)."""
    fq = ring.fq
    N = mles.shape[1]
    step = max(1, _EVAL_VALUES // max(1, mles[:, 0].numel() // ring.nl))
    acc = None
    for lo in range(0, N, step):
        part = mo.sum_mod(fq, mo.mont_mul(fq, mles[:, lo : lo + step], w[:, lo : lo + step]), 1)
        acc = part if acc is None else mo.add(fq, acc, part)
    return acc


def eval_scalar_mles(ring: Ring, mles, eq):
    """Scalar MLEs [nm, N, nl] x eq [N, nl] -> [nm, nl]."""
    return _eval_rows(ring, mles, eq[None])


def eval_ring_mles_scalar(ring: Ring, mles, eq):
    """Ring MLEs [nm, N, ncomp, e, nl] x scalar eq [N, nl] -> [nm, ncomp, e, nl]."""
    return _eval_rows(ring, mles, eq[None, :, None, None, :])
