"""Device-resident Poseidon sponge.

Bit-identical to the host sponge (``transcript.poseidon.PoseidonSponge`` and
the native C++ engine): the same capacity-first state layout, lazy
permutation and round structure as the ark sponge of the reference
transcript (latticefold/src/transcript/poseidon.rs). The counterpart of the
JAX package's ``transcript/device.py``.

The duplex bookkeeping (``index``, ``absorbing``) is Python ints, because the
absorb / squeeze schedule of a prover is fixed once its shapes are; only the
state is a tensor, [t, nl] Montgomery limbs on the device. So a prover that
keeps its transcript here reads nothing back from the device between its
absorbs and its challenges. Absorbing a device ring element (already
Montgomery) is a plain modular add, and a squeezed challenge comes out in
the [e, nl] layout that ``poly.mle.fold`` takes.

On a CUDA state each absorb call, and each squeeze call that permutes,
is one launch of the sponge kernel (``csrc/poseidon_kernel.cu``
``lf_poseidon_sponge``): its permutations back to back in one block, the
rate chunks and the trailing chunk added there, squeezed words written
out (a squeeze that does not permute is a slice of the state). On a CPU
state the same calls run one permutation at a time with ``permute_plain``,
the kernels' reference. ``_permute_kernel`` launches the first design
(``lf_poseidon``, one permutation a launch), which no path takes.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from .. import cuda
from .. import modops as mo
from ..device import constant, resolve
from ..rings.construct import Ring
from .poseidon import get_config


# ---------------------------------------------------------------------------
# permutation
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _perm_consts(ring: Ring):
    """Montgomery-encoded ARK [rounds, t, nl] / MDS [t, t, nl] numpy
    constants, and the Poseidon config (its rounds, rate, capacity)."""
    cfg = get_config(ring.q)
    assert cfg.alpha == 7, "the s-box chain is specialized to alpha = 7"
    fq = ring.fq
    R = 1 << (32 * fq.nl)
    q = ring.q
    ark = fq.encode(np.array([[(v * R) % q for v in row] for row in cfg.ark], dtype=object))
    mds = fq.encode(np.array([[(v * R) % q for v in row] for row in cfg.mds], dtype=object))
    return ark, mds, cfg


@functools.lru_cache(maxsize=None)
def device_consts(ring: Ring, device: torch.device):
    """(ARK, MDS) of ``_perm_consts`` as int64 tensors on ``device``."""
    ark, mds, _ = _perm_consts(ring)
    return constant(ark, device), constant(mds, device)


def _solve_left(A, b, q: int):
    """x with x A = b mod q (A square); raises when A is singular mod q."""
    n = len(A)
    rows = [[A[j][i] % q for j in range(n)] + [b[i] % q] for i in range(n)]  # A^T | b^T
    for col in range(n):
        piv = next((r for r in range(col, n) if rows[r][col]), None)
        if piv is None:
            raise ValueError("singular matrix mod q")
        rows[col], rows[piv] = rows[piv], rows[col]
        inv = pow(rows[col][col], -1, q)
        rows[col] = [v * inv % q for v in rows[col]]
        for r in range(n):
            if r != col and rows[r][col]:
                f = rows[r][col]
                rows[r] = [(a - f * c) % q for a, c in zip(rows[r], rows[col])]
    return [rows[i][n] for i in range(n)]


@functools.lru_cache(maxsize=None)
def fast_consts(ring: Ring) -> dict:
    """The factored permutation's constants as ints mod q (csrc/poseidon.cuh,
    the equivalent form of the Poseidon paper, eprint 2019/458, appendix B):

    - ``ark`` [rf][t]: the full rounds' constants; the first full round
      after the partial ones also takes what the partial rounds' constants
      carry forward (each partial round keeps the constant of word 0, the
      rest of its vector goes through that round's MDS product into the
      next round's);
    - ``mds`` [t][t]; ``pre`` [t][t] = B_1 M, the last full round before the
      partial ones;
    - ``part`` [rp][2t]: partial round k's scalar constant, then S_k's
      corner, row 0 (words 1 .. t-1) and column 0 (words 1 .. t-1), where
      each partial round's matrix A = S B with B = diag(1, A11) moved into
      the round before (A = M for the last one, B M for the others);
    - ``cmat`` [rp][rp]: C_lk = sum_{j>0} S_l[0][j] v_k[j] for k < l, else 0
      (v_k = S_k's column 0), with which the kernel unrolls the partial
      rounds' dots (csrc/poseidon.cuh).

    The factoring needs the (t-1) x (t-1) minor M11 of the MDS matrix to be
    invertible mod q (each A11 is a power of it); raises if it is not."""
    cfg = get_config(ring.q)
    q, t = ring.q, cfg.rate + cfg.capacity
    rf, rp, half = cfg.full_rounds, cfg.partial_rounds, cfg.full_rounds // 2
    M, ark = [list(r) for r in cfg.mds], cfg.ark
    carry, scal = [0] * t, []
    for r in range(half, half + rp):
        ce = [(a + c) % q for a, c in zip(ark[r], carry)]
        scal.append(ce[0])
        carry = [sum(M[i][j] * ce[j] for j in range(1, t)) % q for i in range(t)]
    ark_full = ([list(ark[r]) for r in range(half)]
                + [[(a + c) % q for a, c in zip(ark[half + rp], carry)]]
                + [list(ark[r]) for r in range(half + rp + 1, rf + rp)])
    A, sparse = M, [None] * rp
    for k in reversed(range(rp)):
        A11 = [row[1:] for row in A[1:]]
        try:
            s01 = _solve_left(A11, A[0][1:], q)
        except ValueError:
            raise ValueError(f"Poseidon [{ring.name}]: the MDS matrix's ({t - 1} x {t - 1}) minor is singular mod "
                             "q; the factored partial rounds need it invertible") from None
        sparse[k] = [scal[k], A[0][0]] + s01 + [A[i][0] for i in range(1, t)]
        A = [list(M[0])] + [[sum(A11[i][l] * M[l + 1][j] for l in range(t - 1)) % q for j in range(t)]
                            for i in range(t - 1)]
    cmat = [[sum(sparse[l][1 + j] * sparse[k][t + j] for j in range(1, t)) % q if k < l else 0
             for k in range(rp)] for l in range(rp)]
    return dict(ark=ark_full, mds=M, pre=A, part=sparse, cmat=cmat)


@functools.lru_cache(maxsize=None)
def sponge_consts(ring: Ring, device: torch.device):
    """``fast_consts`` Montgomery-encoded as the sponge kernel's Elems (u32 at
    nl 1, u64 at nl 2, four u64 at nl 8; ark, mds, pre, part, cmat in turn),
    zero-padded to 16 bytes, in an int64 tensor on ``device``; and its size
    in bytes."""
    fc = fast_consts(ring)
    q, R, width = ring.q, 1 << (32 * ring.nl), 4 * ring.nl
    vals = [v for key in ("ark", "mds", "pre", "part", "cmat") for row in fc[key] for v in row]
    buf = b"".join((v * R % q).to_bytes(width, "little") for v in vals)
    buf += bytes(-len(buf) % 16)
    return constant(np.frombuffer(buf, dtype="<i8"), device), len(buf)


def call_segments(n: int, idx: int, switch: bool, rate: int) -> List[Tuple[int, int, int]]:
    """The segments (w, cnt, pos) of one absorb or squeeze call of n > 0
    values at rate index ``idx`` (0 after a mode switch, whose permutation
    comes first): segment k touches rate words [w, w + cnt) with the call's
    values [pos, pos + cnt), and a permutation follows every segment but
    the last. The schedule of ``TraceSponge.absorb`` / ``squeeze``, as the
    sponge kernel runs it (csrc/poseidon.cuh ``lf_call_seg``)."""
    if switch:
        idx = 0
    segs = [(idx, min(n, rate - idx), 0)]
    pos = rate - idx
    while pos < n:
        segs.append((0, min(rate, n - pos), pos))
        pos += rate
    return segs


def call_plan(n: int, idx: int, switch: bool, rate: int) -> Tuple[int, int]:
    """(permutations, rate index afterwards) of one call (``call_segments``)."""
    segs = call_segments(n, idx, switch, rate)
    w, cnt, _ = segs[-1]
    return int(switch) + len(segs) - 1, w + cnt


def sponge_call_plain(ring: Ring, state, vals, n: int, idx: int, switch: bool, perm=None):
    """Plain version of the sponge kernel (``sponge_call``) on the state's
    device: the call's segments with ``permute_plain`` (or ``perm(state)``)
    between them. Returns (state, squeezed [n, nl] or None)."""
    perm = perm or (lambda st: permute_plain(ring, st))
    cfg = get_config(ring.q)
    cap = cfg.capacity
    if switch:
        state = perm(state)
    segs = call_segments(n, idx, switch, cfg.rate)
    out = []
    for k, (w, cnt, pos) in enumerate(segs):
        if vals is not None:
            state = _with_chunk(ring, state, vals[pos : pos + cnt], w)
        else:
            out.append(state[cap + w : cap + w + cnt])
        if k + 1 < len(segs):
            state = perm(state)
    return state, None if vals is not None else torch.cat(out)


def sponge_call(ring: Ring, state, vals, n: int, idx: int, switch: bool):
    """One absorb (``vals`` [n, nl]) or squeeze (``vals`` None) call of the
    sponge kernel (csrc/poseidon_kernel.cu ``lf_poseidon_sponge``) on a CUDA
    ``state`` [t, nl] at rate index ``idx``, after a mode switch if
    ``switch``. Returns (state, squeezed [n, nl] or None)."""
    dev = state.device
    cfg = get_config(ring.q)
    t = cfg.rate + cfg.capacity
    cuda.require_tensor(state, "poseidon state", dev)
    if tuple(state.shape) != (t, ring.nl):
        raise ValueError(f"poseidon state: shape {tuple(state.shape)}, expected ({t}, {ring.nl})")
    if n <= 0 or not 0 <= idx <= cfg.rate:
        raise ValueError(f"poseidon call: {n} values at rate index {idx}")
    if vals is not None:
        cuda.require_tensor(vals, "poseidon values", dev)
        if tuple(vals.shape) != (n, ring.nl):
            raise ValueError(f"poseidon values: shape {tuple(vals.shape)}, expected ({n}, {ring.nl})")
    consts, cbytes = sponge_consts(ring, dev)
    perms, _ = call_plan(n, idx, switch, cfg.rate)
    out_state = torch.empty_like(state)
    out = None if vals is not None else torch.empty((n, ring.nl), dtype=torch.int64, device=dev)
    code = cuda.kernel("poseidon")(
        state.data_ptr(), None if vals is None else vals.data_ptr(), None if out is None else out.data_ptr(),
        out_state.data_ptr(), consts.data_ptr(), cbytes, n, idx, int(switch), t, cfg.rate,
        cfg.full_rounds, cfg.partial_rounds, ring.nl, cuda.field_constants(ring.q, ring.nl),
        cuda.stream_handle(dev),
    )
    cuda.check(code, "poseidon")
    cuda.LAUNCHES["poseidon"] += 1
    cuda.PERMUTATIONS["poseidon"] += perms
    return out_state, out


def _with_chunk(ring: Ring, state, chunk, idx: int):
    """``state`` with ``chunk`` [k, nl] added at rate index ``idx``."""
    if chunk is None or chunk.shape[0] == 0:
        return state
    lo = get_config(ring.q).capacity + idx
    seg = mo.add(ring.fq, state[lo : lo + chunk.shape[0]], chunk)
    return torch.cat([state[:lo], seg, state[lo + chunk.shape[0] :]])


def _permute_kernel(ring: Ring, state, chunk, idx: int):
    """One Poseidon permutation of a CUDA ``state`` [t, nl] after adding
    ``chunk`` [k, nl] at rate index ``idx``, on the first design
    (csrc/poseidon_kernel.cu ``lf_poseidon``: one block of one warp, a lane
    per state word): the sponge kernel's in-call baseline, launched by no
    path (its plain version is ``permute_plain``)."""
    dev = state.device
    cfg = get_config(ring.q)
    ark, mds = device_consts(ring, dev)
    cuda.require_tensor(state, "poseidon state", dev)
    k = 0 if chunk is None else chunk.shape[0]
    if tuple(state.shape) != (cfg.rate + cfg.capacity, ring.nl):
        raise ValueError(f"poseidon state: shape {tuple(state.shape)}, expected ({cfg.rate + cfg.capacity}, {ring.nl})")
    if k:
        cuda.require_tensor(chunk, "poseidon chunk", dev)
        if chunk.shape[1:] != (ring.nl,) or idx + k > cfg.rate:
            raise ValueError(f"poseidon chunk: shape {tuple(chunk.shape)} at rate index {idx}")
    out = torch.empty_like(state)
    code = cuda.kernel("poseidon_perm")(
        state.data_ptr(), chunk.data_ptr() if k else None, k, cfg.capacity + idx,
        ark.data_ptr(), mds.data_ptr(), out.data_ptr(), state.shape[0],
        cfg.full_rounds, cfg.partial_rounds, ring.nl,
        cuda.field_constants(ring.q, ring.nl), cuda.stream_handle(dev),
    )
    cuda.check(code, "poseidon_perm")
    cuda.LAUNCHES["poseidon_perm"] += 1
    cuda.PERMUTATIONS["poseidon_perm"] += 1
    return out


# The plain version works on 24-bit pieces of each value held in int64
# lanes, in Montgomery form with R' = 2^(24 np) (np pieces: 2 for BabyBear,
# 3 for Goldilocks and Frog, 11 for Stark). A product of two pieces is below
# 2^50 and a column sums at most 264 of them, so no sum leaves int64; values
# stay below 3q between reductions (9 q^2 < q R'), so the round constant is
# added without a reduction, the s-box is three Montgomery products, and
# each MDS row is one lazy sum of products reduced once: the plan of the
# kernel, a few hundred torch ops a round instead of the thousands of the
# limb-wise ``modops`` chains.

_PB = 24
_PM = (1 << _PB) - 1


@functools.lru_cache(maxsize=None)
def _piece_consts(ring: Ring, device: torch.device):
    q, nl = ring.q, ring.nl
    npc = -(-(32 * nl) // _PB)
    Rp = 1 << (_PB * npc)
    R = 1 << (32 * nl)
    _, _, cfg = _perm_consts(ring)
    t = cfg.rate + cfg.capacity

    def pieces(v):
        return [(v >> (_PB * k)) & _PM for k in range(npc)]

    def tensor(vals):
        return torch.tensor(vals, dtype=torch.int64, device=device)

    diag = np.zeros((npc, npc, 2 * npc + 1), dtype=np.int64)
    for a in range(npc):
        for b in range(npc):
            diag[a, b, a + b] = 1
    # MDS row i, column j, piece k of the input: mds_ij 2^(24 k) R' mod q
    W = [[[pieces(cfg.mds[i][j] * (1 << (_PB * k)) * Rp % q) for k in range(npc)]
          for j in range(t)] for i in range(t)]
    return dict(
        npc=npc,
        qinv=(-pow(q, -1, 1 << _PB)) % (1 << _PB),
        qp=tensor(pieces(q)),
        qlist=pieces(q),
        diag=torch.from_numpy(diag).to(device),
        W=tensor(W),  # [t, t, npc, npc]
        ark=tensor([[pieces(v * Rp % q) for v in row] for row in cfg.ark]),
        enter=tensor(pieces(Rp * Rp * pow(R, -1, q) % q)),  # R-form -> R'-form
        leave=tensor(pieces(R % q)),  # R'-form -> R-form
        shifts=tensor([8 * i for i in range(4)]),
        bytes_in=tensor([1 << (8 * i) for i in range(3)]),
        full=[r < cfg.full_rounds // 2 or r >= cfg.full_rounds // 2 + cfg.partial_rounds
              for r in range(cfg.full_rounds + cfg.partial_rounds)],
    )


def _redc(pc, cols):
    """Columns [..., n] (n <= 2 np + 1) of T = sum cols[k] 2^(24 k) < q R'
    -> T R'^-1 mod q as np normalized pieces (a value below 2q): np word
    steps of Montgomery reduction, then one carry pass."""
    npc = pc["npc"]
    c = list(cols.unbind(-1))
    c += [0] * (2 * npc + 1 - len(c))
    for k in range(npc):
        mu = ((c[k] & _PM) * pc["qinv"]) & _PM
        for j, qj in enumerate(pc["qlist"]):
            if qj:
                c[k + j] = c[k + j] + mu * qj
        c[k + 1] = c[k + 1] + (c[k] >> _PB)
    out = c[npc:]
    for k in range(npc):
        out[k + 1] = out[k + 1] + (out[k] >> _PB)
        out[k] = out[k] & _PM
    return torch.stack(out[:npc], dim=-1)


def _mul(pc, a, b):
    """Montgomery product (R') of piece vectors a, b [..., np]."""
    prod = a[..., :, None] * b[..., None, :]
    return _redc(pc, (prod[..., None] * pc["diag"]).sum((-3, -2)))


def _pow7(pc, x):
    x2 = _mul(pc, x, x)
    x34 = _mul(pc, torch.stack([x2, x2]), torch.stack([x, x2]))  # x^3, x^4
    return _mul(pc, x34[0], x34[1])


def _limbs_to_pieces(pc, x):
    """[..., nl] 32-bit limbs -> [..., np] 24-bit pieces (the same value)."""
    b = (x[..., None] >> pc["shifts"]) & 0xFF  # [..., nl, 4] bytes
    b = b.reshape(x.shape[:-1] + (-1,))
    b = torch.nn.functional.pad(b, (0, 3 * pc["npc"] - b.shape[-1]))
    return (b.reshape(x.shape[:-1] + (pc["npc"], 3)) * pc["bytes_in"]).sum(-1)


def _pieces_to_limbs(pc, p, nl: int):
    """[..., np] normalized pieces of a value < 2^(32 nl) -> [..., nl] limbs."""
    b = (p[..., None] >> pc["shifts"][:3]) & 0xFF  # [..., np, 3] bytes
    b = b.reshape(p.shape[:-1] + (-1,))[..., : 4 * nl]
    return (b.reshape(p.shape[:-1] + (nl, 4)) << pc["shifts"]).sum(-1)


def _canonical(pc, p):
    """Pieces of a value below 2q -> pieces of the value mod q."""
    d = p - pc["qp"]
    for k in range(pc["npc"] - 1):
        d[..., k + 1] += d[..., k] >> _PB  # arithmetic shift: the borrow
        d[..., k] &= _PM
    return torch.where((d[..., -1:] < 0), p, d)


def permute_plain(ring: Ring, state, chunk=None, idx: int = 0):
    """Plain version of the Poseidon kernel, on the state's device:
    ``permute`` of the JAX package (transcript/device.py) in torch ops, on
    24-bit pieces (see the note above)."""
    pc = _piece_consts(ring, state.device)
    s = _limbs_to_pieces(pc, _with_chunk(ring, state, chunk, idx))
    s = _mul(pc, s, pc["enter"])
    W = pc["W"]
    for ark_row, full in zip(pc["ark"], pc["full"]):
        s = s + ark_row  # below 3q, pieces below 2^25
        if full:
            s = _pow7(pc, s)
        else:
            s = torch.cat([_pow7(pc, s[:1]), s[1:]])
        s = _redc(pc, (s[None, :, :, None] * W).sum((1, 2)))
    s = _canonical(pc, _mul(pc, s, pc["leave"]))
    return _pieces_to_limbs(pc, s, ring.nl)


# ---------------------------------------------------------------------------
# duplex sponge with Python bookkeeping
# ---------------------------------------------------------------------------


class TraceSponge:
    """Duplex sponge on a device state.

    ``state`` is a [t, nl] tensor; ``index`` / ``absorbing`` are Python
    values, so every slice offset below is known without reading the
    device. The mechanics mirror the host sponge exactly (poseidon.py),
    including the resting state index == rate."""

    def __init__(self, ring: Ring, state, index: int, absorbing: bool):
        _, _, cfg = _perm_consts(ring)
        self.ring = ring
        self.rate = cfg.rate
        self.cap = cfg.capacity
        self.state = state
        self.index = index
        self.absorbing = absorbing

    def _permute(self, chunk=None, idx: int = 0):
        self.state = permute_plain(self.ring, self.state, chunk, idx)

    def absorb(self, vals):
        """Absorb ``vals`` [n, nl] (Montgomery field elements): on the card
        one launch of the sponge kernel, on the CPU one permutation at a
        time."""
        n = int(vals.shape[0])
        if n == 0:
            return
        if self.state.device.type != "cpu":
            _, idx = call_plan(n, self.index, not self.absorbing, self.rate)
            self.state, _ = sponge_call(self.ring, self.state, vals.contiguous(), n, self.index, not self.absorbing)
            self.absorbing, self.index = True, idx
            return
        if not self.absorbing:
            self._permute()
            self.absorbing, self.index = True, 0
        pos = 0
        while True:
            if self.index + (n - pos) <= self.rate:
                self.state = _with_chunk(self.ring, self.state, vals[pos:], self.index)
                self.index += n - pos
                return
            num = self.rate - self.index
            self._permute(vals[pos : pos + num] if num else None, self.index)
            pos += num
            self.index = 0

    def squeeze(self, n: int):
        """Squeeze n field elements -> [n, nl] (Montgomery). n = 0 changes
        nothing, as in the host sponge. On the card a call that permutes is
        one launch of the sponge kernel; one that does not is a slice of
        the state."""
        if n == 0:
            return self.state[:0]
        perms, idx = call_plan(n, self.index, self.absorbing, self.rate)
        if perms and self.state.device.type != "cpu":
            self.state, out = sponge_call(self.ring, self.state, None, n, self.index, self.absorbing)
            self.absorbing, self.index = False, idx
            return out
        if self.absorbing:
            self._permute()
            self.absorbing, self.index = False, 0
        out = []
        pos = 0
        while True:
            if self.index + (n - pos) <= self.rate:
                lo = self.cap + self.index
                out.append(self.state[lo : lo + (n - pos)])
                self.index += n - pos
                break
            num = self.rate - self.index
            if num:
                lo = self.cap + self.index
                out.append(self.state[lo : lo + num])
            self._permute()
            pos += num
            self.index = 0
        return out[0] if len(out) == 1 else torch.cat(out)

    # -- transcript-level ops (match transcript/__init__.py) ----------------
    def absorb_ring(self, elts):
        """Absorb ring elements [..., ncomp, e, nl]: component-major flatten,
        the order of Ring.flatten and the host absorb."""
        self.absorb(elts.reshape(-1, elts.shape[-1]))

    def get_challenge(self):
        """Squeeze a K element [e, nl] and re-absorb it (poseidon.rs:51-61)."""
        c = self.squeeze(self.ring.e)
        self.absorb(c)
        return c

    def absorb_field_element(self, c):
        """Absorb a K element [e, nl] as its diagonal ring embedding
        (transcript.rs:20-22): the e coordinates repeated ncomp times."""
        self.absorb_ring(c.expand((self.ring.ncomp,) + tuple(c.shape)))


class GhostSponge:
    """Index / mode-only duplex simulator: the (index, absorbing) trajectory
    of an absorb / squeeze schedule, with no state. ``perms`` counts the
    permutations that ``TraceSponge`` makes on the same schedule (a switch
    of mode permutes, and so does each crossing of the end of the rate),
    ``launches`` its launches of the sponge kernel on the card (each absorb
    call, and each squeeze call that permutes)."""

    def __init__(self, ring: Ring, index: int, absorbing: bool):
        _, _, cfg = _perm_consts(ring)
        self.rate = cfg.rate
        self.index = index
        self.absorbing = absorbing
        self.perms = 0
        self.launches = 0

    def _run(self, n: int, absorbing: bool):
        if n == 0:
            return
        perms, self.index = call_plan(n, self.index, self.absorbing != absorbing, self.rate)
        self.absorbing = absorbing
        self.perms += perms
        self.launches += absorbing or perms > 0

    def absorb(self, n: int):
        self._run(n, True)

    def squeeze(self, n: int):
        self._run(n, False)


# ---------------------------------------------------------------------------
# device short challenges (byte-exact ports of transcript/__init__.py's
# decoders: squeeze_bytes truncation per poseidon.py, the per-ring decode of
# cyclotomic-rings/src/rings/{goldilocks,babybear,stark,frog}.rs)
# ---------------------------------------------------------------------------


def _bytes_needed(ring: Ring) -> int:
    return {"goldilocks": 18, "babybear": 18, "stark": 16, "frog": 16}[ring.name]


def squeeze_bytes_trace(sp: TraceSponge, n: int):
    """Squeeze n sponge bytes -> int64 tensor [n] (each 0..255) on the
    state's device, matching PoseidonSponge.squeeze_bytes: byte b of an
    element is byte b % 4 of its canonical limb b // 4, and an element gives
    (q.bit_length() - 1) // 8 bytes."""
    ring = sp.ring
    usable = (ring.q.bit_length() - 1) // 8
    nelems = -(-n // usable)
    canon = mo.from_mont(ring.fq, sp.squeeze(nelems))  # [nelems, nl]
    shifts = torch.arange(0, 32, 8, device=canon.device)
    bs = (canon[..., None] >> shifts) & 0xFF  # [nelems, nl, 4]
    return bs.reshape(nelems, 4 * ring.nl)[:, :usable].reshape(-1)[:n]


def short_challenge_trace(sp: TraceSponge):
    """One short (low-norm) challenge: the coefficient vector as canonical
    limbs [d, nl]. Bit-exact against Transcript.get_short_challenge."""
    ring = sp.ring
    bs = squeeze_bytes_trace(sp, _bytes_needed(ring))
    if ring.name in ("goldilocks", "babybear"):
        b0, b1, b2 = bs.reshape(6, 3).unbind(1)
        x0 = (b0 & 0x3F) - 32
        x1 = (((b0 & 0xC0) >> 6) | ((b1 & 0x0F) << 2)) - 32
        x2 = (((b1 & 0xF0) >> 4) | ((b2 & 0x03) << 4)) - 32
        x3 = ((b2 & 0xFC) >> 2) - 32
        digs = torch.stack([x0, x1, x2, x3], dim=1).reshape(24)
        # BabyBear: only the first 24 of 72 coefficients are filled
        digs = torch.nn.functional.pad(digs, (0, ring.d - 24))
    elif ring.name == "stark":
        digs = bs
    elif ring.name == "frog":
        digs = bs - 128
    else:
        raise ValueError(ring.name)
    return mo.digits_to_field(ring.fq, digs)  # [d, nl] canonical


# ---------------------------------------------------------------------------
# host <-> device sponge state bridging
# ---------------------------------------------------------------------------


def export_state(ring: Ring, transcript, device=None) -> Tuple[torch.Tensor, int, bool]:
    """Snapshot the host transcript's sponge into ([t, nl] Montgomery tensor
    on ``device`` (None: CUDA), index, absorbing)."""
    ints, index, absorbing = transcript.snapshot_state()
    R = 1 << (32 * ring.nl)
    vals = np.array([(int(s) * R) % ring.q for s in ints], dtype=object)
    return constant(ring.fq.encode(vals), resolve(device)), index, absorbing


def import_state(ring: Ring, transcript, state_dev, index: int, absorbing: bool):
    """Write a device sponge state back into the host transcript (reads the
    device)."""
    can = mo.from_mont(ring.fq, state_dev).cpu().numpy()
    ints = [int(v) for v in ring.fq.decode(can)]
    transcript.restore_state(ints, index, absorbing)


def k_from_device(ring: Ring, arr) -> List[tuple]:
    """[..., e, nl] Montgomery K coords -> host K tuples (nested lists)."""
    ints = ring.fq.decode(mo.from_mont(ring.fq, arr).cpu().numpy())  # [..., e] object

    def conv(a):
        if a.ndim == 1:
            return tuple(int(v) for v in a)
        return [conv(a[i]) for i in range(a.shape[0])]

    return conv(ints)

