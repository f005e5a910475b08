"""Witness pipeline: gadget decomposition, CRT, and the f-hat tables.

  f_coeff = gadget_decompose_B,L(ICRT(w_ccs))     (balanced digits, |.| < B)
  f       = CRT(f_coeff)
  f_hat   = tau MLE tables packing the base-field coefficients of f_coeff
            into NTT components as subfield constants:
            f_hat[j][i].component[c] = const-embed(f_coeff[i].coeff[j*ncomp+c])

Digit layout: f_coeff[i*L + j] = j-th radix-B digit of w_ccs[i].
For B >= 2^16, B-digits are formed by recombining K balanced base-b digits
(b = B_SMALL < 2^16), which keeps |digit| < B and recomposition exact.
Every CRT/ICRT here goes through ``rings.ops.crt``/``icrt``: the tensor-core
CRT kernel on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import modops as mo
from ..params import DecompositionParams
from ..rings import ops as rops
from ..rings.construct import Ring

_SMALL_BASE_LIMIT = 1 << 16


def _mont_pow(ring: Ring, b: int, i: int) -> int:
    """b^i in Montgomery form."""
    return pow(b, i, ring.q) * (1 << (32 * ring.nl)) % ring.q


def gadget_decompose(ring: Ring, dp: DecompositionParams, coeff_canon):
    """[N, d, nl] canonical coeffs -> [N*L, d, nl] canonical digit elements."""
    m = ring.fq
    N = coeff_canon.shape[0]
    assert dp.B**dp.L > ring.q, (
        f"gadget base B={dp.B} with L={dp.L} digits cannot cover q={ring.q}"
    )
    if dp.B < _SMALL_BASE_LIMIT:
        digs = mo.signed_digits(m, coeff_canon, dp.B, dp.L)  # [N, d, L]
        f = mo.digits_to_field(m, digs)  # [N, d, L, nl]
    else:
        assert dp.b**dp.K == dp.B, "composite gadget path needs b^K == B"
        digs = mo.signed_digits(m, coeff_canon, dp.b, dp.L * dp.K)  # [N, d, L*K]
        fb = mo.digits_to_field(m, digs).reshape(N, ring.d, dp.L, dp.K, ring.nl)
        # B-digit = sum_i b^i * b-digit_i  (field-space recombination)
        acc = None
        for i in range(dp.K):
            term = mo.mul_const(m, mo.to_mont(m, fb[:, :, :, i, :]), _mont_pow(ring, dp.b, i))
            acc = term if acc is None else mo.add(m, acc, term)
        f = mo.from_mont(m, acc)  # canonical [N, d, L, nl]
    # layout: element i, digit j -> row i*L + j
    return f.movedim(2, 1).reshape(N * dp.L, ring.d, ring.nl)


def gadget_recompose(ring: Ring, dp: DecompositionParams, f_ntt):
    """[N*L, ncomp, e, nl] NTT digits -> [N, ncomp, e, nl]: sum_j B^j f[i*L+j]."""
    N = f_ntt.shape[0] // dp.L
    fr = f_ntt.reshape(N, dp.L, ring.ncomp, ring.e, ring.nl)
    acc = None
    for j in range(dp.L):
        term = mo.mul_const(ring.fq, fr[:, j], _mont_pow(ring, dp.B, j))
        acc = term if acc is None else mo.add(ring.fq, acc, term)
    return acc


def make_fhat(ring: Ring, f_coeff_canon, n_pad: int):
    """[N, d, nl] canonical digits -> f_hat [tau, n_pad, ncomp, nl] (mont),
    stored compactly: f-hat values are subfield constants (K-coordinate 0
    only), so the extension axis is omitted."""
    N = f_coeff_canon.shape[0]
    mont = mo.to_mont(ring.fq, f_coeff_canon)  # [N, d, nl]
    # coeff index j*ncomp + c -> (chunk j, component c)
    out = mont.reshape(N, ring.tau, ring.ncomp, ring.nl).movedim(1, 0)
    if n_pad > N:
        pad = out.new_zeros((ring.tau, n_pad - N, ring.ncomp, ring.nl))
        out = torch.cat([out, pad], dim=1)
    return out.contiguous()


@dataclass
class Witness:
    """Device-resident CCS witness (tensors on one device)."""

    ring: Ring
    dp: DecompositionParams
    w_ccs: torch.Tensor  # [n_w, ncomp, e, nl] NTT mont
    f: torch.Tensor  # [n_w*L, ncomp, e, nl] NTT mont
    f_coeff: Optional[torch.Tensor]  # [n_w*L, d, nl] canonical
    f_hat: torch.Tensor  # [tau, n_pad, ncomp, nl] subfield-compact (see make_fhat)

    @classmethod
    def from_w_ccs(cls, ring: Ring, dp: DecompositionParams, w_ccs, n_pad: int):
        w_coeff = mo.from_mont(ring.fq, rops.icrt(ring, w_ccs))
        f_coeff = gadget_decompose(ring, dp, w_coeff)
        f = rops.crt(ring, mo.to_mont(ring.fq, f_coeff))
        f_hat = make_fhat(ring, f_coeff, n_pad)
        return cls(ring, dp, w_ccs, f, f_coeff, f_hat)

    @classmethod
    def from_f_coeff(cls, ring: Ring, dp: DecompositionParams, f_coeff, n_pad: int):
        f = rops.crt(ring, mo.to_mont(ring.fq, f_coeff))
        f_hat = make_fhat(ring, f_coeff, n_pad)
        w_ccs = gadget_recompose(ring, dp, f)
        return cls(ring, dp, w_ccs, f, f_coeff, f_hat)

    @classmethod
    def from_f(cls, ring: Ring, dp: DecompositionParams, f, n_pad: int):
        f_coeff = mo.from_mont(ring.fq, rops.icrt(ring, f))
        f_hat = make_fhat(ring, f_coeff, n_pad)
        w_ccs = gadget_recompose(ring, dp, f)
        return cls(ring, dp, w_ccs, f, f_coeff, f_hat)

    def commit(self, scheme):
        return scheme.commit(self.f)

    def within_bound(self, bound: int) -> bool:
        """max |signed coeff of f| < bound (testing)."""
        ints = self.ring.fq.decode(self.f_coeff.cpu().numpy())
        q = self.ring.q
        mx = 0
        for v in ints.reshape(-1):
            s = int(v) if int(v) <= q // 2 else q - int(v)
            mx = max(mx, s)
        return mx < bound
