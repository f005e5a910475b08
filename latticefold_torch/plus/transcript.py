"""LatticeFold+ transcript: Poseidon sponge with coefficient-form absorbs.

Mirrors the plus crate's PoseidonTranscript (transcript.rs:25-55): the
sponge of the LatticeFold side (the C++ one for q < 2^64), but ring
elements are absorbed as their d coefficients (CoeffRing semantics) and a
challenge is ONE base prime field element, squeezed then re-absorbed
(extension_degree == 1 for every shipped coefficient ring's base field).
"""

from __future__ import annotations

from typing import List

from ..rings.construct import Ring
from ..transcript import Transcript
from . import coeffring as cr


class PlusTranscript:
    def __init__(self, ring: Ring):
        cr.require_power2(ring)
        self.ring = ring
        self._inner = Transcript(ring)
        self.sponge = self._inner.sponge

    # -- absorbing ----------------------------------------------------------
    def absorb_coeffs(self, coeffs: List[int]):
        """Absorb one ring element given as its d coefficients."""
        self.sponge.absorb([c % self.ring.q for c in coeffs])

    def absorb_coeffs_slice(self, elts):
        for e in elts:
            self.absorb_coeffs(e)

    def absorb_scalar(self, v: int):
        """absorb_field_element: the constant polynomial [v, 0, .., 0]
        (latticefold/src/transcript.rs:21-23 with From::from)."""
        self.absorb_coeffs(cr.cconst(self.ring, v))

    def absorb_tag(self, tag: bytes):
        """squeeze_challenges' name absorb (plus transcript.rs:62-64): the
        tag's big-endian integer mod q, as a scalar."""
        self.absorb_scalar(int.from_bytes(tag, "big") % self.ring.q)

    # -- challenges ---------------------------------------------------------
    def get_challenge(self) -> int:
        """Squeeze one base-field element, re-absorb it, return it as an int."""
        c = self.sponge.squeeze_native(1)
        self.sponge.absorb(c)
        return int(c[0])

    def get_challenges(self, n: int) -> List[int]:
        return [self.get_challenge() for _ in range(n)]

    def squeeze_bytes(self, n: int) -> bytes:
        return self.sponge.squeeze_bytes(n)

    def short_challenge(self, lam: int = 128) -> List[int]:
        """Low-norm coefficient-form challenge (plus utils.rs:87-100):
        squeeze d bytes, coeff_i = (b_i mod u) - u/2 with u = 2^(lam/d)."""
        ring = self.ring
        u = 1 << (lam // ring.d)
        bs = self.squeeze_bytes(ring.d)
        return [((b % u) - u // 2) % ring.q for b in bs]

    def short_challenges(self, n: int, lam: int = 128) -> List[List[int]]:
        return [self.short_challenge(lam) for _ in range(n)]

    # -- sponge state ---------------------------------------------------------
    def snapshot_state(self):
        return self._inner.snapshot_state()

    def restore_state(self, state_ints, index: int, absorbing: bool):
        self._inner.restore_state(state_ints, index, absorbing)
