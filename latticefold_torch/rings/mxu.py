"""Ajtai commitment contraction over NTT-form ring elements.

cm[k, b, c] = sum_n A[k, n, c] *_K f[n, b, c]  -- the function the JAX
package computes with ``rings/mxu.py:ajtai_commit`` and with its fused
Pallas kernel ``rings/pallas_commit.py``. On a CUDA tensor ``ajtai_commit``
launches the hand-written kernel ``csrc/commit_kernel.cu`` for every width
n and batch; on a CPU tensor it runs the plain version beside it. Nothing
falls back from one to the other.
"""

from __future__ import annotations

import torch

from .. import cuda
from . import ops
from .construct import Ring

_BLOCKS_PER_SM = 8  # pass-1 blocks to aim for on each SM
_SMEM_BYTES = 48 * 1024


def ajtai_commit_plain(ring: Ring, matrix, f):
    """Plain version: matrix [kappa, n, c, e, nl], f [n, Nb, c, e, nl] ->
    [kappa, Nb, c, e, nl]. Every K product at once, then a modular tree sum
    over n."""
    prod = ops.ring_mul(ring, matrix[:, :, None], f[None])  # [kappa, n, Nb, ...]
    return ops.ring_sum(ring, prod, 1)


def commit_plan(ring: Ring, kappa: int, n: int, Nb: int, sms: int):
    """(nchunks, chunk, TN): how pass 1 splits the sum over n across blocks
    of a card with ``sms`` SMs and how many n it stages per shared-memory
    tile."""
    elem_bytes = 4 * ring.nl  # an F_q value in shared memory (u32, u64 or 4 x u64)
    tn = min(32, _SMEM_BYTES // (elem_bytes * ring.e * (kappa + Nb)))
    if tn < 1:
        raise ValueError(f"commit kernel: kappa + Nb = {kappa + Nb} too large")
    nchunks = max(1, min(-(-n // tn), -(-_BLOCKS_PER_SM * sms // ring.ncomp)))
    chunk = -(-n // nchunks)
    nchunks = -(-n // chunk)
    return nchunks, chunk, tn


def _commit_kernel(ring: Ring, matrix, f):
    """Launch csrc/commit_kernel.cu (both passes) on CUDA tensors. An (nl, e)
    without a template instance there makes the launcher return an error
    code, which ``cuda.check`` raises."""
    dev = f.device
    kappa, n = matrix.shape[0], matrix.shape[1]
    Nb = f.shape[1]
    if f.shape[0] != n:
        raise ValueError(f"witness length {f.shape[0]} != matrix width {n}")
    cuda.require_tensor(matrix, "commit matrix", dev)
    cuda.require_tensor(f, "commit witness", dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nchunks, chunk, tn = commit_plan(ring, kappa, n, Nb, sms)
    S = 2 * ring.e - 1
    partial = torch.empty(
        (nchunks, ring.ncomp, kappa * Nb, S, ring.nl), dtype=torch.int64, device=dev
    )
    out = torch.empty(
        (kappa, Nb, ring.ncomp, ring.e, ring.nl), dtype=torch.int64, device=dev
    )
    red = ops.red_rows(ring, dev)
    fn = cuda.kernel("commit")
    code = fn(
        matrix.data_ptr(), f.data_ptr(), 0 if red is None else red.data_ptr(),
        partial.data_ptr(), out.data_ptr(), kappa, n, Nb, ring.ncomp, ring.e,
        ring.nl, nchunks, chunk, tn, cuda.field_constants(ring.q, ring.nl),
        cuda.stream_handle(dev),
    )
    cuda.check(code, "commit")
    cuda.LAUNCHES["commit"] += 1
    return out


def ajtai_commit(ring: Ring, matrix, f):
    """Commit a batch of witnesses: f [n, Nb, ncomp, e, nl] ->
    [kappa, Nb, ncomp, e, nl] (matrix [kappa, n, ncomp, e, nl])."""
    if f.device.type == "cpu":
        return ajtai_commit_plain(ring, matrix, f)
    return _commit_kernel(ring, matrix, f.contiguous())
