"""Grain-LFSR Poseidon parameter generation (Poseidon paper, appendix B).

Generates the round constants (ARK) and the Cauchy MDS matrix for a given
prime field and state size, following the standard derivation used by
ark-crypto-primitives' ``find_poseidon_ark_and_mds`` — which is how the
reference's hard-coded tables
(crates/cyclotomic-rings/src/rings/poseidon/*.rs) were
produced. Generating instead of copying keeps the source of truth the
published algorithm; tests assert spot values against the reference tables'
first entries to guarantee transcript compatibility.
"""

from __future__ import annotations

import functools
from typing import List, Tuple


class GrainLFSR:
    def __init__(
        self,
        is_sbox_inverse: bool,
        prime_num_bits: int,
        state_len: int,
        num_full_rounds: int,
        num_partial_rounds: int,
    ):
        state = [False] * 80
        # b0..b1: field type GF(p) -> 01
        state[1] = True
        # b2..b5: s-box exponent descriptor
        state[5] = is_sbox_inverse
        # b6..b17: n = prime_num_bits (big-endian)
        cur = prime_num_bits
        for i in range(17, 5, -1):
            state[i] = (cur & 1) == 1
            cur >>= 1
        # b18..b29: t = state_len
        cur = state_len
        for i in range(29, 17, -1):
            state[i] = (cur & 1) == 1
            cur >>= 1
        # b30..b39: R_F
        cur = num_full_rounds
        for i in range(39, 29, -1):
            state[i] = (cur & 1) == 1
            cur >>= 1
        # b40..b49: R_P
        cur = num_partial_rounds
        for i in range(49, 39, -1):
            state[i] = (cur & 1) == 1
            cur >>= 1
        # b50..b79: ones
        for i in range(50, 80):
            state[i] = True
        self.state = state
        self.prime_num_bits = prime_num_bits
        self.head = 0
        for _ in range(160):
            self._next_bit()

    def _next_bit(self) -> bool:
        s, head = self.state, self.head
        nb = (
            s[(head + 62) % 80]
            ^ s[(head + 51) % 80]
            ^ s[(head + 38) % 80]
            ^ s[(head + 23) % 80]
            ^ s[(head + 13) % 80]
            ^ s[head]
        )
        s[head] = nb
        self.head = (head + 1) % 80
        return nb

    def get_bits(self, n: int) -> List[bool]:
        out = []
        while len(out) < n:
            # rejection pairing: if the first bit is 1 the second is output
            if self._next_bit():
                out.append(self._next_bit())
            else:
                self._next_bit()
        return out

    def _bits_to_int_be(self, bits: List[bool]) -> int:
        v = 0
        for b in bits:
            v = (v << 1) | int(b)
        return v

    def field_elements_rejection(self, q: int, n: int) -> List[int]:
        out = []
        while len(out) < n:
            v = self._bits_to_int_be(self.get_bits(self.prime_num_bits))
            if v < q:
                out.append(v)
        return out

    def field_elements_mod_p(self, q: int, n: int) -> List[int]:
        return [
            self._bits_to_int_be(self.get_bits(self.prime_num_bits)) % q
            for _ in range(n)
        ]


@functools.lru_cache(maxsize=None)
def find_poseidon_ark_and_mds(
    q: int,
    prime_num_bits: int,
    state_len: int,
    full_rounds: int,
    partial_rounds: int,
    skip_matrices: int = 0,
) -> Tuple[tuple, tuple]:
    """Returns (ark, mds): ark is (R_F+R_P) x t, mds is t x t (Cauchy)."""
    lfsr = GrainLFSR(False, prime_num_bits, state_len, full_rounds, partial_rounds)
    ark = tuple(
        tuple(lfsr.field_elements_rejection(q, state_len))
        for _ in range(full_rounds + partial_rounds)
    )
    for _ in range(skip_matrices):
        lfsr.field_elements_mod_p(q, 2 * state_len)
    xs = lfsr.field_elements_mod_p(q, state_len)
    ys = lfsr.field_elements_mod_p(q, state_len)
    mds = tuple(
        tuple(pow((x + y) % q, q - 2, q) for y in ys) for x in xs
    )
    return ark, mds
