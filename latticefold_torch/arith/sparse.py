"""Sparse constraint matrices with batched SpMV on tensors.

ELL-style padded layout, as in the JAX package: gather witness rows,
multiply, and fold the (small) per-row nonzero axis -- all vectorized over
the m constraint rows. Supports F_q-scalar coefficients (R1CS/CCS matrices
are integer matrices, i.e. diagonal ring constants) and general ring-element
coefficients.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import modops as mo
from ..rings import ops as rops
from ..rings.construct import Ring

# gathered F_q values (batch x rows x nonzeros x value) per chunk of rows
_MATVEC_VALUES = 1 << 23


class SparseMatrix:
    """rows: per-row list of (coeff, col). coeff: int (F_q) or host ring elt."""

    def __init__(self, ring: Ring, nrows: int, ncols: int, rows: List[List[Tuple]]):
        assert len(rows) == nrows
        self.ring = ring
        self.nrows = nrows
        self.ncols = ncols
        self.rows = rows
        self._dev = {}
        self._t = None

    def transpose(self) -> "SparseMatrix":
        """M^T as a SparseMatrix (cached, built host-side once: constraint
        matrices are static). Enables mle[Mz](r) = <z, M^T eq_r> without
        retaining Mz tables."""
        if self._t is not None:
            # a pad_rows after a cached transpose would leave stale dims
            assert self._t.ncols == self.nrows and self._t.nrows == self.ncols
        if self._t is None:
            rows_t: List[List[Tuple]] = [[] for _ in range(self.ncols)]
            for i, row in enumerate(self.rows):
                for c, j in row:
                    rows_t[j].append((c, i))
            self._t = SparseMatrix(self.ring, self.ncols, self.nrows, rows_t)
            self._t._t = self
        return self._t

    @classmethod
    def from_dense(cls, ring: Ring, dense: Sequence[Sequence[int]]):
        rows = [
            [(int(v), j) for j, v in enumerate(r) if int(v) != 0] for r in dense
        ]
        return cls(ring, len(dense), len(dense[0]), rows)

    def pad_rows(self, size: int):
        if size > self.nrows:
            self.rows = self.rows + [[] for _ in range(size - self.nrows)]
            self.nrows = size
            self._dev = {}
            self._t = None  # a cached transpose has stale ncols

    @property
    def scalar_coeffs(self) -> bool:
        return all(isinstance(c, int) for row in self.rows for (c, _) in row)

    # ------------------------------------------------------------------
    def _device(self, device: torch.device):
        if device not in self._dev:
            ring = self.ring
            nnz = max((len(r) for r in self.rows), default=0)
            nnz = max(nnz, 1)
            cols = np.zeros((self.nrows, nnz), dtype=np.int64)
            if self.scalar_coeffs:
                R = 1 << (32 * ring.nl)
                vals = np.zeros((self.nrows, nnz), dtype=object)
                for i, row in enumerate(self.rows):
                    for k, (c, j) in enumerate(row):
                        cols[i, k] = j
                        vals[i, k] = c % ring.q * R % ring.q
                coeffs = torch.from_numpy(ring.fq.encode(vals).astype(np.int64))
                self._dev[device] = ("scalar", torch.from_numpy(cols).to(device), coeffs.to(device))
            else:
                elts = []
                for i, row in enumerate(self.rows):
                    r = []
                    for k in range(nnz):
                        if k < len(row):
                            c, j = row[k]
                            cols[i, k] = j
                            r.append(ring.embed_int(c) if isinstance(c, int) else c)
                        else:
                            r.append(ring.zero())
                    elts.append(r)
                coeffs = rops.to_device(ring, elts, device)  # [m, nnz, ncomp, e, nl]
                self._dev[device] = ("ring", torch.from_numpy(cols).to(device), coeffs)
        return self._dev[device]

    def mat_vec(self, z):
        """z: [ncols, ncomp, e, nl] -> [nrows, ncomp, e, nl]."""
        return self.mat_vec_batched(z[None])[0]

    def mat_vec_batched(self, z_batch, out=None):
        """z_batch: [B, ncols, ncomp, e, nl] -> [B, nrows, ncomp, e, nl],
        into ``out`` where given (it must not overlap ``z_batch``). Rows
        are taken _MATVEC_VALUES gathered F_q values at a time, so the
        gather and its products stay bounded."""
        kind, cols, coeffs = self._device(z_batch.device)
        B, nnz = z_batch.shape[0], cols.shape[1]
        if out is None:
            out = z_batch.new_empty((B, self.nrows) + tuple(z_batch.shape[2:]))
        step = max(1, _MATVEC_VALUES // max(1, B * nnz * z_batch[0, 0].numel() // self.ring.nl))
        for lo in range(0, self.nrows, step):
            gathered = z_batch[:, cols[lo : lo + step]]  # [B, rows, nnz, ncomp, e, nl]
            if kind == "scalar":
                prod = mo.mont_mul(self.ring.fq, gathered, coeffs[lo : lo + step, :, None, None, :])
            else:
                prod = rops.ring_mul(self.ring, gathered, coeffs[lo : lo + step])
            del gathered
            # fold the small nnz axis sequentially (nnz is tiny)
            acc = prod[:, :, 0]
            for k in range(1, nnz):
                acc = rops.ring_add(self.ring, acc, prod[:, :, k])
            out[:, lo : lo + step] = acc
        return out

    # host reference path (for tiny verifier-side checks / tests)
    def mat_vec_host(self, z: list):
        ring = self.ring
        out = []
        for row in self.rows:
            acc = ring.zero()
            for c, j in row:
                cc = ring.embed_int(c) if isinstance(c, int) else c
                acc = ring.radd(acc, ring.rmul(cc, z[j]))
            out.append(acc)
        return out

    def transpose_mul_scalar_host(self, ring: Ring, w: List[int]) -> List[int]:
        """u = M^T w for F_q scalar weights (host). Requires scalar
        coefficients; the LatticeFold+ set check's and range check's
        transpose trick (plus/setchk.py, plus/rgchk.py)."""
        if not self.scalar_coeffs:
            raise NotImplementedError("transpose trick needs F_q-scalar matrix entries")
        q = ring.q
        out = [0] * self.ncols
        for i, row in enumerate(self.rows):
            wi = w[i] if i < len(w) else 0
            if not wi:
                continue
            for c, j in row:
                out[j] = (out[j] + c * wi) % q
        return out
