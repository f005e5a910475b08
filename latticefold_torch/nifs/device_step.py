"""The whole NIFS fold step with the Fiat-Shamir transcript on the device.

The modular prover (``nifs.prove``) follows the reference's host-sequential
structure (nifs.rs:48-102) and reads the device wherever it absorbs a value:
round messages, evaluation claims, commitments, each challenge's way back.
``DeviceNIFS.prove`` runs the same protocol -- the linearization sumcheck,
two K-way decompositions (digit split, CRT, the batch commit), the folding
sumcheck and the short-rho folds -- with the transcript resident on the
device (``transcript.device``): nothing is read back between the export of
the transcript state and the decode of the proof, so one step's device work
is a sequence of launches that no host read interrupts. The counterpart of
the JAX package's ``nifs/device_step.py`` (one XLA program there; an eager
sequence here, which a CUDA graph could capture).

Transcript-identical to the modular path by construction (the same absorb /
squeeze schedule and sponge), so the proof bytes, the folded instance and
witness and the final transcript state are the modular prover's.

The batch commit of each decomposition takes the byte-plane route
(``AjtaiScheme.commit_batch_fused``, kernels A and B), as the modular
prover does: the same limbs as ``mxu.ajtai_commit`` (the Hopper commit
kernel), which the JAX step calls, at about a third of its time at the
Goldilocks fold's shape (PERF.md section 5).

Scope: decomposition parameters with B < 2^16 (the statement split takes B
digits directly): Goldilocks, Frog, BabyBear and DP_GOLDILOCKS_B16; the
Stark presets' composite gadget takes the modular path.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple

import numpy as np
import torch

from .. import modops as mo
from .. import sumcheck as sc
from ..arith.ccs import CCCS, CCS, LCCCS, Commitment
from ..arith.witness import Witness
from ..commitment import AjtaiScheme
from ..device import constant
from ..params import DecompositionParams
from ..poly import mle as mlemod
from ..rings import ops as rops
from ..rings.construct import Ring
from ..transcript import Transcript
from ..transcript import device as dtr
from . import LFProof
from . import decomposition as dec_mod
from . import folding as fold_mod
from . import linearization as lin_mod
from .folding import FoldingProof
from .linearization import LinearizationProof


# ---------------------------------------------------------------------------
# small device helpers
# ---------------------------------------------------------------------------


def _mont(ring: Ring, v: int) -> int:
    return v % ring.q * (1 << (32 * ring.nl)) % ring.q


@functools.lru_cache(maxsize=None)
def _one_coeff(ring: Ring, device: torch.device):
    """The ring's one in coefficient form, [d, nl] canonical."""
    vals = np.zeros((ring.d,), dtype=object)
    vals[0] = 1
    return constant(ring.fq.encode(vals), device)


def _absorb_tag(sp: dtr.TraceSponge, tag: bytes):
    """Transcript.absorb_tag on the device sponge."""
    sp.absorb_ring(sc._embed_int_dev(sp.ring, int.from_bytes(tag, "big"), sp.state.device))


def _absorb_k_points(sp: dtr.TraceSponge, pts):
    """Absorb K points [n, e, nl] as their diagonal ring embeddings."""
    ring = sp.ring
    sp.absorb_ring(pts[:, None].expand((pts.shape[0], ring.ncomp) + tuple(pts.shape[1:])))


def _rho_fold(ring: Ring, stacked, rhos):
    """sum_i rhos[i] * stacked[i] over the leading axis; rhos [n, ncomp, e, nl]."""
    rho_b = rhos.reshape(rhos.shape[:1] + (1,) * (stacked.ndim - 4) + tuple(rhos.shape[1:]))
    return rops.ring_sum(ring, rops.ring_mul(ring, stacked, rho_b), 0)


def mul_by_x_dev(ring: Ring, x):
    """X * f on canonical coefficient tensors [..., d, nl] (rotation.rs:45-60)."""
    top = x[..., -1, :]
    out = torch.cat([mo.neg(ring.fq, top)[..., None, :], x[..., :-1, :]], dim=-2)
    if ring.n_cyc == 3 * ring.d:  # X^d - X^{d/2} + 1: X^d = X^{d/2} - 1
        mid = ring.d // 2
        out[..., mid, :] = mo.add(ring.fq, out[..., mid, :], top)
    return out


def rot_lin_combination_dev(ring: Ring, rho_coeff, theta_flat):
    """The RotSum fold (rotation.rs:84-104): rho_coeff [2K, d, nl] canonical;
    theta_flat [2K, d, e, nl] Montgomery (the component-major flatten of the
    tau evaluation claims). Returns v_0 [tau, ncomp, e, nl] Montgomery."""
    cur = rho_coeff
    rows = []
    for _ in range(ring.d):
        rows.append(cur)
        cur = mul_by_x_dev(ring, cur)
    Rm = mo.to_mont(ring.fq, torch.stack(rows, dim=1))  # [2K, d(i), d(j), nl]
    # res[j] = sum_{k,i} R[k, i, j] * theta_flat[k, i]
    prod = mo.mont_mul(ring.fq, Rm[..., None, :], theta_flat[:, :, None])  # [2K, i, j, e, nl]
    summed = mo.sum_mod(ring.fq, mo.sum_mod(ring.fq, prod, 1), 0)  # [j, e, nl]
    return summed.reshape(ring.tau, ring.ncomp, ring.e, ring.nl)


# ---------------------------------------------------------------------------
# the subprotocols on the device sponge
# ---------------------------------------------------------------------------


class DevLCCCS(NamedTuple):
    """An LCCCS held on the device: r [s, e, nl]; v [tau, ...]; cm
    [kappa, ...]; u [t, ...]; xw_h [l + 1, ...] = x_w || h."""

    r: torch.Tensor
    v: torch.Tensor
    cm: torch.Tensor
    u: torch.Tensor
    xw_h: torch.Tensor


def _trace_linearization(sp, ccs: CCS, comb, cmi_cm, cmi_x, wi_wccs, wi_fhat):
    """linearization.rs:145-189 on the device sponge. Returns (DevLCCCS,
    evals, v, u)."""
    ring = ccs.ring
    dev = cmi_cm.device
    _absorb_tag(sp, b"beta_s")
    beta = torch.stack([sp.get_challenge() for _ in range(ccs.s)])  # [s, e, nl]

    one = sc._embed_int_dev(ring, 1, dev)[None]
    z = torch.cat([cmi_x, one, wi_wccs])
    Mz = torch.stack([M.mat_vec(z) for M in ccs.M])  # [t, m, ...]

    sel = [Mz[j] for i, Si in enumerate(ccs.S) if ccs.c[i] != 0 for j in Si]
    mles = torch.stack(sel + [mlemod.build_eq(ring, beta)])
    evals, chals, _ = sc.trace_prove(sp, mles, ccs.s, ccs.d + 1, comb)
    del mles

    v = mlemod.evaluate_subfield(ring, wi_fhat, chals)  # [tau, c, e, nl]
    u = mlemod.evaluate(ring, Mz, chals)  # [t, c, e, nl]
    sp.absorb_ring(v)
    sp.absorb_ring(u)
    inst = DevLCCCS(r=chals, v=v, cm=cmi_cm, u=u, xw_h=torch.cat([cmi_x, one]))
    return inst, evals, v, u


def _split_statement(ring: Ring, dp: DecompositionParams, xw_h):
    """decompose_big_vec_into_k_vec_and_compose_back (decomposition/utils.rs:
    12-42) on the device: [lx, c, e, nl] -> [K, lx, c, e, nl]."""
    fq = ring.fq
    coeffs = mo.from_mont(fq, rops.icrt(ring, xw_h))  # [lx, d, nl] canonical
    fB = mo.digits_to_field(fq, mo.signed_digits(fq, coeffs, dp.B, dp.L))  # [lx, d, L, nl]
    fb = mo.digits_to_field(fq, mo.signed_digits(fq, fB, dp.b, dp.K))  # [lx, d, L, K, nl]
    out = []
    for k in range(dp.K):
        acc = None
        for j in range(dp.L):
            term = mo.mul_const(fq, mo.to_mont(fq, fb[:, :, j, k]), _mont(ring, pow(dp.B, j, ring.q)))
            acc = term if acc is None else mo.add(fq, acc, term)
        out.append(rops.crt(ring, acc))  # [lx, c, e, nl]
    return torch.stack(out)


def _trace_decomposition(sp, ccs: CCS, dp, scheme: AjtaiScheme, inst: DevLCCCS, wit: Witness):
    """decomposition.rs:33-88 on the device sponge. Returns (instances,
    (f [K, NL, ...], f_hat [K, tau, m, ...]), z [K, ncols, ...], Mz [K, t,
    m, ...], proof tensors)."""
    ring = ccs.ring
    wits = dec_mod.decompose_witness(ring, dp, wit, ccs.m)
    x_split = _split_statement(ring, dp, inst.xw_h)  # [K, lx, ...]

    # y_1..y_{K-1} as one batch on the byte-plane route; y_0 derived
    if dp.K > 1:
        cms = scheme.commit_batch_fused(dec_mod.digit_batch(ring, [w.f for w in wits[1:]]))
    else:
        cms = inst.cm.new_zeros((scheme.kappa, 0) + tuple(inst.cm.shape[1:]))
    b_k = sc._embed_int_dev(ring, dp.b, inst.cm.device)[0]  # the K element b
    b_sum = torch.zeros_like(inst.cm)
    for i in range(dp.K - 2, -1, -1):
        b_sum = rops.scalar_mul(ring, rops.ring_add(ring, b_sum, cms[:, i]), b_k)
    y_s = torch.cat([rops.ring_sub(ring, inst.cm, b_sum)[:, None], cms], dim=1)  # [kappa, K, ...]

    fhat_all = torch.stack([w.f_hat for w in wits])  # [K, tau, m, c, nl]
    v_s = mlemod.evaluate_subfield(ring, fhat_all, inst.r)  # [K, tau, c, e, nl]
    z_s = torch.stack([torch.cat([x_split[k], wits[k].w_ccs]) for k in range(dp.K)])
    mz_s = torch.stack([torch.stack([M.mat_vec(z) for M in ccs.M]) for z in z_s])  # [K, t, m, ...]
    u_s = mlemod.evaluate(ring, mz_s, inst.r)  # [K, t, c, e, nl]

    insts = []
    for k in range(dp.K):
        sp.absorb_ring(x_split[k])
        sp.absorb_ring(y_s[:, k])
        sp.absorb_ring(u_s[k])
        sp.absorb_ring(v_s[k])
        insts.append(DevLCCCS(r=inst.r, v=v_s[k], cm=y_s[:, k], u=u_s[k], xw_h=x_split[k]))
    f_all = torch.stack([w.f for w in wits])
    proof = {"u_s": u_s, "v_s": v_s, "x_s": x_split, "y_s": y_s}
    return insts, (f_all, fhat_all), z_s, mz_s, proof


def _trace_folding(sp, ccs: CCS, dp, comb, insts: List[DevLCCCS], f_all, fhat_all, z_all, mz_all):
    """folding.rs:42-130 on the device sponge."""
    ring = ccs.ring
    dev = f_all.device
    two_k = 2 * dp.K
    log_m = ccs.s

    _absorb_tag(sp, b"alpha_s")
    alphas = torch.stack([sp.get_challenge() for _ in range(two_k)])
    _absorb_tag(sp, b"zeta_s")
    zetas = torch.stack([sp.get_challenge() for _ in range(two_k)])
    _absorb_tag(sp, b"mu_s")
    # one challenge less, then one (folding/utils.rs:77-83)
    mus = torch.stack([sp.get_challenge() for _ in range(two_k - 1)] + [sc._embed_int_dev(ring, 1, dev)[0]])
    _absorb_tag(sp, b"beta_s")
    beta = torch.stack([sp.get_challenge() for _ in range(log_m)])

    eq1 = mlemod.build_eq(ring, insts[0].r)
    eq2 = mlemod.build_eq(ring, insts[dp.K].r)
    mles = fold_mod.prepare_folding_mles_streaming(
        ring, dp.K, fhat_all, z_all, ccs, eq1, eq2, mlemod.build_eq(ring, beta), alphas, zetas
    )
    del eq1, eq2
    evals, r0, finals = sc.trace_prove(sp, mles, log_m, 2 * dp.b, comb, mus)
    del mles

    theta_s = finals[5:].reshape(two_k, ring.tau, ring.ncomp, ring.e, ring.nl)
    eta_s = mlemod.evaluate(ring, mz_all, r0)  # [2K, t, c, e, nl]
    for i in range(two_k):
        sp.absorb_ring(theta_s[i])
    for i in range(two_k):
        sp.absorb_ring(eta_s[i])

    _absorb_tag(sp, b"rho_s")
    rho_coeff = torch.stack([dtr.short_challenge_trace(sp) for _ in range(two_k - 1)] + [_one_coeff(ring, dev)])
    rho_ntt = rops.crt(ring, mo.to_mont(ring.fq, rho_coeff))  # [2K, c, e, nl]

    f0 = _rho_fold(ring, f_all, rho_ntt)
    # v_0 by RotSum; the theta flatten is component-major within each tau row
    v0 = rot_lin_combination_dev(ring, rho_coeff, theta_s.reshape(two_k, ring.d, ring.e, ring.nl))
    cm0 = _rho_fold(ring, torch.stack([i.cm for i in insts]), rho_ntt)
    # u_0 folds the eta claims (at r_0), as folding/utils.rs:460-521 and the
    # modular prover do; the JAX step folds the instances' u (at r) here
    u0 = _rho_fold(ring, eta_s, rho_ntt)
    x0 = _rho_fold(ring, torch.stack([i.xw_h for i in insts]), rho_ntt)

    folded = DevLCCCS(r=r0, v=v0, cm=cm0, u=u0, xw_h=x0)
    return folded, f0, {"evals": evals, "theta_s": theta_s, "eta_s": eta_s}


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


class DeviceNIFS:
    """NIFS prover bound to (ccs, dp, scheme), with the transcript on the
    scheme's device. ``prove`` is call-compatible with ``nifs.prove`` (host
    LCCCS and transcript in and out, device witnesses); ``_trace`` is its
    device part, which reads nothing back from the device."""

    def __init__(self, ccs: CCS, dp: DecompositionParams, scheme: AjtaiScheme):
        if dp.B >= 1 << 16:
            raise ValueError(
                f"DeviceNIFS takes B < 2^16 (its statement split takes B digits directly); B = {dp.B}: "
                "use nifs.prove"
            )
        self.ccs, self.dp, self.scheme = ccs, dp, scheme
        self.ring = ring = ccs.ring
        dev = scheme.matrix.device
        # everything the device part reads that is made on the host, made here
        self._lin_comb = lin_mod._lin_comb(ring, tuple(tuple(s) for s in ccs.S), tuple(ccs.c), dev)
        self._fold_comb = fold_mod._folding_comb(ring, 2 * dp.K, ring.tau, dp.b, dev)
        scheme._fused_planes  # noqa: B018 -- the byte-plane route's planes, made once
        dtr.sponge_consts(ring, dev)

    def _trace(self, state0, idx0: int, abs0: bool, acc: DevLCCCS, w_acc: Witness,
               cmi_cm, cmi_x, w_i: Witness):
        """The fold on the device: the transcript state [t, nl] and its
        bookkeeping in, the device sponge, the folded DevLCCCS and witness
        and the proof's tensors out."""
        ccs, dp, ring = self.ccs, self.dp, self.ring
        sp = dtr.TraceSponge(ring, state0, idx0, abs0)

        # absorb_public_input (nifs.rs:175-197)
        _absorb_tag(sp, b"acc")
        _absorb_k_points(sp, acc.r)
        sp.absorb_ring(acc.v)
        sp.absorb_ring(acc.cm)
        sp.absorb_ring(acc.u)
        sp.absorb_ring(acc.xw_h)
        _absorb_tag(sp, b"cm_i")
        sp.absorb_ring(cmi_cm)
        sp.absorb_ring(cmi_x)

        lin_inst, lin_evals, lin_v, lin_u = _trace_linearization(
            sp, ccs, self._lin_comb, cmi_cm, cmi_x, w_i.w_ccs, w_i.f_hat
        )
        insts_l, wits_l, z_l, mz_l, dproof_l = _trace_decomposition(sp, ccs, dp, self.scheme, acc, w_acc)
        insts_r, wits_r, z_r, mz_r, dproof_r = _trace_decomposition(sp, ccs, dp, self.scheme, lin_inst, w_i)
        folded, f0, fproof = _trace_folding(
            sp, ccs, dp, self._fold_comb, insts_l + insts_r,
            torch.cat([wits_l[0], wits_r[0]]), torch.cat([wits_l[1], wits_r[1]]),
            torch.cat([z_l, z_r]), torch.cat([mz_l, mz_r]),
        )
        del wits_l, wits_r, z_l, z_r, mz_l, mz_r
        w0 = Witness.from_f(ring, dp, f0, ccs.m)  # arith.rs:299-313
        return sp, folded, w0, {"lin": {"evals": lin_evals, "v": lin_v, "u": lin_u},
                                "dec_l": dproof_l, "dec_r": dproof_r, "fold": fproof}

    def prove(self, acc: LCCCS, w_acc: Witness, cm_i: CCCS, w_i: Witness, transcript: Transcript):
        """``nifs.prove(acc, w_acc, cm_i, w_i, transcript, ccs, scheme, dp)``:
        returns (folded LCCCS, folded Witness, LFProof) and leaves the
        transcript where the modular prover leaves it."""
        ring, ccs = self.ring, self.ccs
        ccs.sanity_check(self.dp.L)
        dev = w_i.f.device
        state0, idx0, abs0 = dtr.export_state(ring, transcript, dev)
        acc_dev = DevLCCCS(
            r=mlemod.point_to_device(ring, acc.r, dev),
            v=rops.to_device(ring, list(acc.v), dev),
            cm=rops.to_device(ring, list(acc.cm.vals), dev),
            u=rops.to_device(ring, list(acc.u), dev),
            xw_h=rops.to_device(ring, list(acc.x_w) + [acc.h], dev),
        )
        cmi_cm = rops.to_device(ring, list(cm_i.cm.vals), dev)
        cmi_x = rops.to_device(ring, list(cm_i.x_ccs), dev)
        sp, folded, w0, out = self._trace(state0, idx0, abs0, acc_dev, w_acc, cmi_cm, cmi_x, w_i)
        dtr.import_state(ring, transcript, sp.state, sp.index, sp.absorbing)
        return self._decode_lcccs(folded), w0, self._decode_proof(out)

    # -- decoders -------------------------------------------------------------
    def _decode_lcccs(self, d: DevLCCCS) -> LCCCS:
        ring = self.ring
        xw = list(rops.to_host(ring, d.xw_h))
        return LCCCS(
            r=[tuple(c) for c in dtr.k_from_device(ring, d.r)],
            v=list(rops.to_host(ring, d.v)),
            cm=Commitment(ring, list(rops.to_host(ring, d.cm))),
            u=list(rops.to_host(ring, d.u)),
            x_w=xw[:-1],
            h=xw[-1],
        )

    def _decode_sumcheck(self, evals) -> sc.SumcheckProof:
        evs_host = rops.to_host(self.ring, evals)  # [nvars, deg+1]
        return sc.SumcheckProof([list(evs_host[r]) for r in range(evs_host.shape[0])])

    def _decode_dec(self, d) -> dec_mod.DecompositionProof:
        ring, K = self.ring, self.dp.K
        u_s, v_s, x_s = (rops.to_host(ring, d[k]) for k in ("u_s", "v_s", "x_s"))
        y_s = rops.to_host(ring, d["y_s"])  # [kappa, K]
        return dec_mod.DecompositionProof(
            u_s=[list(u_s[k]) for k in range(K)],
            v_s=[list(v_s[k]) for k in range(K)],
            x_s=[list(x_s[k]) for k in range(K)],
            y_s=[Commitment(ring, list(y_s[:, k])) for k in range(K)],
        )

    def _decode_proof(self, out) -> LFProof:
        ring = self.ring
        theta = rops.to_host(ring, out["fold"]["theta_s"])
        eta = rops.to_host(ring, out["fold"]["eta_s"])
        return LFProof(
            linearization_proof=LinearizationProof(
                sumcheck=self._decode_sumcheck(out["lin"]["evals"]),
                v=list(rops.to_host(ring, out["lin"]["v"])),
                u=list(rops.to_host(ring, out["lin"]["u"])),
            ),
            decomposition_proof_l=self._decode_dec(out["dec_l"]),
            decomposition_proof_r=self._decode_dec(out["dec_r"]),
            folding_proof=FoldingProof(
                sumcheck=self._decode_sumcheck(out["fold"]["evals"]),
                theta_s=[list(theta[i]) for i in range(theta.shape[0])],
                eta_s=[list(eta[i]) for i in range(eta.shape[0])],
            ),
        )
