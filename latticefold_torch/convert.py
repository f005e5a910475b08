"""Carry state between the JAX package and the port as numpy arrays.

The port imports nothing of the JAX package; this module takes plain numpy
arrays of u32 limbs (the layout both packages share at their public
functions: NTT form ``[..., ncomp, e, nl]``, coefficient form ``[..., d, nl]``,
Montgomery where the JAX package keeps Montgomery) and returns the port's
tensors and objects on a given device, and back. A LatticeFold+ setup
crosses as its Ajtai matrix (``ajtai_scheme``) and its committed R1CS
instance with the sparse matrices' row lists (``com_r1cs``).
"""

from __future__ import annotations

import numpy as np
import torch

from .arith.sparse import SparseMatrix
from .arith.witness import Witness
from .commitment import AjtaiScheme
from .device import resolve
from .params import DecompositionParams
from .plus.r1cs import ComR1CS, ComR1CSX
from .rings.construct import Ring


def tensor(arr, device=None) -> torch.Tensor:
    """u32 limb array (any shape) -> int64 tensor on ``device`` (None: CUDA).
    Use for MLE tables, witness vectors and any other limb array."""
    a = np.asarray(arr)
    if a.dtype != np.uint32:
        raise TypeError(f"expected uint32 limbs, got {a.dtype}")
    return torch.from_numpy(a.astype(np.int64)).to(resolve(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 limb tensor -> u32 numpy array (the JAX package's layout)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def ajtai_scheme(ring: Ring, matrix, device=None) -> AjtaiScheme:
    """Ajtai matrix [kappa, n, ncomp, e, nl] u32 Montgomery -> AjtaiScheme."""
    return AjtaiScheme.from_matrix(ring, tensor(matrix, device))


def witness(
    ring: Ring, dp: DecompositionParams, w_ccs, f, f_coeff, f_hat, device=None
) -> Witness:
    """A witness's arrays (w_ccs/f Montgomery NTT form, f_coeff canonical
    coefficients or None, f_hat subfield-compact) -> Witness."""
    return Witness(
        ring=ring,
        dp=dp,
        w_ccs=tensor(w_ccs, device),
        f=tensor(f, device),
        f_coeff=None if f_coeff is None else tensor(f_coeff, device),
        f_hat=tensor(f_hat, device),
    )


def com_r1cs(ring: Ring, matrices, z, f, cm_f, l_in: int, device=None) -> ComR1CS:
    """A committed R1CS instance: ``matrices`` as (nrows, ncols, rows)
    triples ([A, B, C]; a row: (coeff, col) pairs), z [m, ncomp, e, nl] and
    f [n, ncomp, e, nl] u32 Montgomery NTT form, cm_f as kappa coefficient
    lists (host ints)."""
    mats = [SparseMatrix(ring, nrows, ncols, [list(r) for r in rows]) for nrows, ncols, rows in matrices]
    x = ComR1CSX(matrices=mats, z=tensor(z, device), cm_f=[list(c) for c in cm_f], l_in=l_in)
    return ComR1CS(x=x, f=tensor(f, device))
