"""Fiat-Shamir transcript over cyclotomic rings.

Mirrors the reference `Transcript` / `TranscriptWithShortChallenges` traits
(crates/latticefold/src/transcript.rs:13-51) and the
Poseidon-backed implementation (transcript/poseidon.rs:29-75):

- ``absorb(ring_elt)`` absorbs the d base-prime-field coordinates
  (component-major flatten) in one sponge call;
- ``get_challenge()`` squeezes ``e`` native elements, **re-absorbs them**, and
  returns them as a K element (used diagonally embedded in the ring);
- ``get_short_challenge()`` squeezes ``BYTES_NEEDED`` bytes and decodes a
  low-norm coefficient vector via the per-ring challenge set
  (cyclotomic-rings/src/rings/{goldilocks,babybear,stark,frog}.rs).
"""

from __future__ import annotations

from typing import List, Sequence

from ..rings.construct import Ring
from .poseidon import PoseidonSponge, get_config


# ---------------------------------------------------------------------------
# short-challenge decoders (byte-exact ports of the challenge-set decodes)
# ---------------------------------------------------------------------------


def _decode_6bit_signed(bs: bytes, q: int) -> List[int]:
    """18 bytes -> 24 coefficients in [-32, 32) (goldilocks.rs:41-67)."""
    assert len(bs) == 18
    out = []
    for i in range(6):
        b0, b1, b2 = bs[3 * i], bs[3 * i + 1], bs[3 * i + 2]
        x0 = (b0 & 0b00111111) - 32
        x1 = (((b0 & 0b11000000) >> 6) | ((b1 & 0b00001111) << 2)) - 32
        x2 = (((b1 & 0b11110000) >> 4) | ((b2 & 0b00000011) << 4)) - 32
        x3 = ((b2 & 0b11111100) >> 2) - 32
        out.extend([x0 % q, x1 % q, x2 % q, x3 % q])
    return out


def short_challenge_coeffs(ring: Ring, bs: bytes) -> List[int]:
    """Decode ``bytes_needed(ring)`` sponge bytes into d coefficients."""
    q = ring.q
    if ring.name in ("goldilocks", "babybear"):
        coeffs = _decode_6bit_signed(bs, q)
        # BabyBear: only the first 24 of 72 coefficients are filled
        # (babybear.rs:51-66 allocates 24 and RqPoly::from zero-pads).
        return coeffs + [0] * (ring.d - 24)
    if ring.name == "stark":
        return [b % q for b in bs]  # [0, 256) unsigned (stark.rs:48-50)
    if ring.name == "frog":
        return [(b - 128) % q for b in bs]  # [-128, 128) (frog.rs:49-54)
    raise ValueError(ring.name)


def bytes_needed(ring: Ring) -> int:
    return {"goldilocks": 18, "babybear": 18, "stark": 16, "frog": 16}[ring.name]


# ---------------------------------------------------------------------------


class Transcript:
    def __init__(self, ring: Ring):
        self.ring = ring
        cfg = get_config(ring.q)
        sponge = None
        if ring.q.bit_length() <= 64:  # native C++ engine for 64-bit fields
            from ..native import NativeSponge, get_lib

            lib = get_lib()
            if lib is not None:
                sponge = NativeSponge(cfg, lib)
        self.sponge = sponge if sponge is not None else PoseidonSponge(cfg)

    # -- absorbing ----------------------------------------------------------
    def absorb(self, elt):
        """Absorb one ring element (host NTT form: tuple of ncomp K-tuples)."""
        self.sponge.absorb(self.ring.flatten(elt))

    def absorb_slice(self, elts: Sequence):
        for e in elts:
            self.absorb(e)

    def absorb_field_element(self, kelt):
        """Absorb a K element as its diagonal ring embedding (transcript.rs:20-22)."""
        self.absorb(self.ring.embed_k(kelt))

    def absorb_tag(self, tag: bytes):
        """Domain-separation tag: F_q element from big-endian bytes mod q,
        absorbed as a field element (e.g. nifs.rs:180-182, folding/utils.rs:56-58)."""
        v = int.from_bytes(tag, "big") % self.ring.q
        self.absorb_field_element(self.ring.K.embed(v))

    # -- challenges ---------------------------------------------------------
    def get_challenge(self):
        """Squeeze a K element; re-absorbs the squeezed coordinates."""
        c = self.sponge.squeeze_native(self.ring.e)
        self.sponge.absorb(c)
        return tuple(c)

    def get_challenges(self, n: int):
        return [self.get_challenge() for _ in range(n)]

    def squeeze_bytes(self, n: int) -> bytes:
        return self.sponge.squeeze_bytes(n)

    def get_short_challenge(self) -> List[int]:
        """Low-norm challenge as a coefficient vector (d F_q ints)."""
        bs = self.squeeze_bytes(bytes_needed(self.ring))
        return short_challenge_coeffs(self.ring, bs)

    def get_short_challenges(self, n: int):
        return [self.get_short_challenge() for _ in range(n)]

    # -- device bridging ------------------------------------------------------
    def snapshot_state(self):
        """(state ints [t], index, absorbing) — for transcript.device export."""
        sp = self.sponge
        if hasattr(sp, "snapshot"):
            return sp.snapshot()
        return list(sp.state), sp.index, sp.mode_absorbing

    def restore_state(self, state_ints, index: int, absorbing: bool):
        sp = self.sponge
        if hasattr(sp, "restore"):
            sp.restore(state_ints, index, absorbing)
        else:
            sp.state = list(state_ints)
            sp.index = index
            sp.mode_absorbing = absorbing
