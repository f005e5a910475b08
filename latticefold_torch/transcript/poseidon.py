"""Poseidon sponge with ark-crypto-primitives-compatible duplex mechanics.

State layout: ``capacity`` elements first, then ``rate`` (absorb adds into
``state[capacity + i]``); lazy permutation exactly as the ark sponge, so the
squeezed streams match the reference transcript
(crates/latticefold/src/transcript/poseidon.rs) bit-for-bit
— validated by the KATs at poseidon.rs:85-143 (see tests/test_transcript.py).

All four rings use R_F=8, R_P=22, alpha=7, rate=20, capacity=4
(cyclotomic-rings/src/rings/poseidon/*.rs:9-11,1423).
"""

from __future__ import annotations

import functools
from typing import List, Sequence

from .grain import find_poseidon_ark_and_mds


class PoseidonConfig:
    def __init__(self, q: int, full_rounds=8, partial_rounds=22, alpha=7, rate=20, capacity=4):
        self.q = q
        self.full_rounds = full_rounds
        self.partial_rounds = partial_rounds
        self.alpha = alpha
        self.rate = rate
        self.capacity = capacity
        self.ark, self.mds = find_poseidon_ark_and_mds(
            q, q.bit_length(), rate + capacity, full_rounds, partial_rounds
        )


@functools.lru_cache(maxsize=None)
def get_config(q: int) -> PoseidonConfig:
    return PoseidonConfig(q)


class PoseidonSponge:
    def __init__(self, config: PoseidonConfig):
        self.cfg = config
        t = config.rate + config.capacity
        self.state: List[int] = [0] * t
        self.mode_absorbing = True
        self.index = 0  # next absorb / squeeze index within the rate portion

    # ----- permutation -----------------------------------------------------
    def _permute(self):
        cfg = self.cfg
        q, alpha = cfg.q, cfg.alpha
        state = self.state
        t = len(state)
        half = cfg.full_rounds // 2
        total = cfg.full_rounds + cfg.partial_rounds
        for rnd in range(total):
            ark_row = cfg.ark[rnd]
            full = rnd < half or rnd >= half + cfg.partial_rounds
            state = [(s + a) % q for s, a in zip(state, ark_row)]
            if full:
                state = [pow(s, alpha, q) for s in state]
            else:
                state[0] = pow(state[0], alpha, q)
            state = [
                sum(state[j] * cfg.mds[i][j] for j in range(t)) % q
                for i in range(t)
            ]
        self.state = state

    # ----- duplex absorb/squeeze (ark-compatible) --------------------------
    def absorb(self, elements: Sequence[int]):
        if len(elements) == 0:
            return
        if not self.mode_absorbing:
            self._permute()
            self.mode_absorbing, self.index = True, 0
        cfg = self.cfg
        rem = [e % cfg.q for e in elements]
        idx = self.index
        while True:
            if idx + len(rem) <= cfg.rate:
                for i, e in enumerate(rem):
                    self.state[cfg.capacity + idx + i] = (
                        self.state[cfg.capacity + idx + i] + e
                    ) % cfg.q
                self.index = idx + len(rem)
                return
            num = cfg.rate - idx
            for i in range(num):
                self.state[cfg.capacity + idx + i] = (
                    self.state[cfg.capacity + idx + i] + rem[i]
                ) % cfg.q
            self._permute()
            rem = rem[num:]
            idx = 0

    def squeeze_native(self, n: int) -> List[int]:
        if n == 0:
            return []
        if self.mode_absorbing:
            self._permute()
            self.mode_absorbing, self.index = False, 0
        cfg = self.cfg
        out: List[int] = []
        idx = self.index
        remaining = n
        while True:
            if idx + remaining <= cfg.rate:
                out.extend(self.state[cfg.capacity + idx : cfg.capacity + idx + remaining])
                self.index = idx + remaining
                return out
            num = cfg.rate - idx
            out.extend(self.state[cfg.capacity + idx : cfg.capacity + idx + num])
            self._permute()
            remaining -= num
            idx = 0

    def squeeze_bytes(self, n: int) -> bytes:
        cfg = self.cfg
        usable = (cfg.q.bit_length() - 1) // 8
        nelems = -(-n // usable)
        elems = self.squeeze_native(nelems)
        # ark: BigInt little-endian bytes, truncated to `usable` per element
        nbytes_per = ((cfg.q.bit_length() + 63) // 64) * 8
        buf = b"".join(e.to_bytes(nbytes_per, "little")[:usable] for e in elems)
        return buf[:n]
