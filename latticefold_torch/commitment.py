"""Ajtai (Module-SIS) commitments.

The scheme is a public random kappa x n matrix over the NTT-form ring; a
commitment is the ring matrix-vector product A f. The matrix is sampled on
the host from the same seeded numpy stream as the JAX package's, so both
packages hold the same matrix bit for bit. The fold's batch commits (the
decomposition's K - 1 digit witnesses) go through ``commit_batch_fused``:
the byte-plane route of ``rings.plane_commit`` (int8 tensor-core planes,
kernels A and B). ``commit_device``, ``commit_batch`` and
``commit_batch_cm`` go through ``rings.mxu.ajtai_commit``, the commit
kernel on the card, which computes the same limbs and is the route's
cross-check.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import modops as mo
from .arith.ccs import Commitment
from .device import resolve
from .rings import mxu, plane_commit
from .rings import ops as rops
from .rings.construct import Ring


def _sample_limbs(rng: np.random.Generator, q: int, nl: int, shape) -> np.ndarray:
    """Uniform canonical F_q values as u32 limbs [*shape, nl], by rejection
    sampling on q.bit_length() bits: the JAX package's numpy stream (draws of
    ``words`` 32-bit values per candidate, need + 7 candidates a round),
    compared with q limb by limb so no value is assembled as a Python int."""
    total = int(np.prod(shape))
    bits = q.bit_length()
    words = (bits + 31) // 32
    q_limbs = [(q >> (32 * i)) & 0xFFFFFFFF for i in range(words)]
    top_mask = np.uint64((1 << (bits - 32 * (words - 1))) - 1)
    out = np.zeros((total, nl), dtype=np.uint32)
    filled = 0
    while filled < total:
        need = total - filled
        raw = rng.integers(0, 1 << 32, size=(need + 7, words), dtype=np.uint64)
        raw[:, -1] &= top_mask
        below = np.zeros(raw.shape[0], dtype=bool)
        equal = np.ones(raw.shape[0], dtype=bool)
        for i in range(words - 1, -1, -1):
            below |= equal & (raw[:, i] < q_limbs[i])
            equal &= raw[:, i] == q_limbs[i]
        acc = raw[below][:need]
        out[filled : filled + len(acc), :words] = acc
        filled += len(acc)
    return out.reshape(tuple(shape) + (nl,))


class AjtaiScheme:
    """kappa x n matrix of uniform NTT-form ring elements, seed-deterministic.

    ``device``: where the matrix lives and commits run; None means CUDA
    (raises without a card)."""

    def __init__(self, ring: Ring, kappa: int, n: int, seed: int = 0, device=None):
        dev = resolve(device)
        self.ring = ring
        self.kappa = kappa
        self.n = n
        rng = np.random.default_rng(np.random.PCG64(seed))
        shape = (kappa, n, ring.ncomp, ring.e)
        canon = torch.from_numpy(_sample_limbs(rng, ring.q, ring.nl, shape).astype(np.int64))
        self.matrix = mo.to_mont(ring.fq, canon.to(dev))  # Montgomery-encoded on the device

    @classmethod
    def from_matrix(cls, ring: Ring, matrix: torch.Tensor):
        """A scheme around an existing Montgomery matrix [kappa, n, c, e, nl]."""
        self = cls.__new__(cls)
        self.ring, self.kappa, self.n = ring, matrix.shape[0], matrix.shape[1]
        self.matrix = matrix.contiguous()
        return self

    @classmethod
    def identity_like(cls, ring: Ring, kappa: int, n: int, device=None):
        """Deterministic A[i][j] = diag(i*n + j), the reference's test generator."""
        R = 1 << (32 * ring.nl)
        vals = np.zeros((kappa, n, ring.ncomp, ring.e), dtype=object)
        for i in range(kappa):
            for j in range(n):
                vals[i, j, :, 0] = (i * n + j) % ring.q * R % ring.q
        matrix = torch.from_numpy(ring.fq.encode(vals).astype(np.int64))
        return cls.from_matrix(ring, matrix.to(resolve(device)))

    def commit_device(self, f) -> torch.Tensor:
        """f: [n, ncomp, e, nl] -> [kappa, ncomp, e, nl]."""
        if f.shape[0] != self.n:
            raise ValueError(f"witness length {f.shape[0]} != scheme width {self.n}")
        return self.commit_batch(f[:, None])[:, 0]

    def commit_batch(self, f) -> torch.Tensor:
        """Batched commit: f [n, Nb, ...] -> [kappa, Nb, ...]."""
        return mxu.ajtai_commit(self.ring, self.matrix, f)

    def commit_batch_cm(self, fcm) -> torch.Tensor:
        """Batched commit of a component-major witness batch
        [ncomp, n, e, Nb, nl] -> [kappa, Nb, ncomp, e, nl]: the commit
        kernel after a permute to [n, Nb, ncomp, e, nl]."""
        return self.commit_batch(fcm.permute(1, 3, 0, 2, 4))

    @functools.cached_property
    def _fused_planes(self) -> plane_commit.FusedPlanes:
        return plane_commit.precompute(self.ring, self.matrix)

    def commit_batch_fused(self, fcm) -> torch.Tensor:
        """``commit_batch_cm`` on the byte-plane route (kernels A and B of
        ``rings/plane_commit.py``): the same limbs. Any layout: a batch
        whose rows do not start 16 bytes apart is copied into aligned
        storage first (``plane_commit.aligned_batch``)."""
        fcm = plane_commit.aligned_batch(self.ring, fcm)
        return plane_commit.ajtai_commit_fused(self.ring, self._fused_planes, fcm)

    def commit(self, f) -> Commitment:
        return Commitment(self.ring, list(rops.to_host(self.ring, self.commit_device(f))))
