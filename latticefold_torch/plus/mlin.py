"""Mlin folding (LatticeFold+ Construction 5.2) and the LinB instance types.

Port of the reference's lin.rs and mlin.rs: a ``LinB`` is a linearized
committed instance (witness f, commitment cm_f, paired evaluation
points/values); ``mlin`` folds L of them by building an ``RgInstance`` per
input, running the commitment transformation, and summing the per-instance
outputs g / cm_g / vo (mlin.rs:40-104). ``lin`` is the L = 1 special case
(lin.rs:47-62).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from ..arith.sparse import SparseMatrix
from ..commitment import AjtaiScheme
from ..rings import ops as rops
from . import coeffring as cr
from .cm import CmProof, cm_prove
from .rgchk import DecompParameters, Rg, RgInstance
from .transcript import PlusTranscript


@dataclass
class LinParameters:
    """lin.rs:23-27."""

    kappa: int
    decomp: DecompParameters


@dataclass
class LinBX:
    """lin.rs:29-34: cm_f (kappa coeff lists), paired points and values."""

    cm_f: List[list]
    r: List[Tuple[int, int]]
    v: List[Tuple[list, list]]


@dataclass
class LinB:
    """lin.rs:36-40: f is the witness tensor [n, ncomp, e, nl]."""

    f: torch.Tensor
    x: LinBX


@dataclass
class LinB2X:
    """mlin.rs:21-26."""

    cm_g: List[list]
    ro: List[Tuple[int, int]]
    vo: List[Tuple[list, list]]


@dataclass
class LinB2:
    g: torch.Tensor
    x: LinB2X


@dataclass
class Mlin:
    lins: List[LinB]
    params: LinParameters

    def mlin(
        self, scheme: AjtaiScheme, M: Sequence[SparseMatrix], transcript: PlusTranscript
    ) -> Tuple[LinB2, CmProof]:
        """mlin.rs:42-105."""
        ring = scheme.ring
        n = self.lins[0].f.shape[0]
        nvars = (n - 1).bit_length()

        instances = [RgInstance.from_f(ring, lin.f, scheme, self.params.decomp) for lin in self.lins]
        rg = Rg(nvars=nvars, instances=instances, dparams=self.params.decomp)
        com, proof = cm_prove(rg, M, transcript)

        # sum per-instance outputs (mlin.rs:66-101)
        kappa = self.params.kappa
        cm_g = [cr.czero(ring) for _ in range(kappa)]
        for cmi in com.x.cm_g:
            for i in range(kappa):
                cm_g[i] = cr.cadd(ring, cm_g[i], cmi[i])

        nlin = len(com.x.vo[0])
        vo = [(cr.czero(ring), cr.czero(ring)) for _ in range(nlin)]
        for v_l in com.x.vo:
            vo = [(cr.cadd(ring, a0, v0), cr.cadd(ring, a1, v1)) for (a0, a1), (v0, v1) in zip(vo, v_l)]

        g = com.g[0]
        for gi in com.g[1:]:
            g = rops.ring_add(ring, g, gi)

        return LinB2(g=g, x=LinB2X(cm_g=cm_g, ro=com.x.ro, vo=vo)), proof


def lin(
    linb: LinB,
    scheme: AjtaiScheme,
    M: Sequence[SparseMatrix],
    params: LinParameters,
    transcript: PlusTranscript,
) -> Tuple[LinB2, CmProof]:
    """Pi_lin = Pi_mlin with a single instance (lin.rs:47-62)."""
    return Mlin(lins=[linb], params=params).mlin(scheme, M, transcript)
