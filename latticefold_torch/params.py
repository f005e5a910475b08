"""Decomposition parameters and the 128-bit security predicate.

Port of the parameter machinery in
crates/latticefold/src/decomposition_parameters.rs:11-114 and
the security formulas of utils/security_check.rs:5-45 / notebooks/bounds.sage:5-42.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class DecompositionParams:
    """B: MSIS bound; L: q < B^L; b (B_SMALL): folding base; K = log_b B."""

    B: int
    L: int
    b: int
    K: int

    def __post_init__(self):
        # K digits of base b must cover bound-B values (FrogDP in the
        # reference has b^K > B, so equality is not required in general).
        assert self.b**self.K >= self.B, "require b^K >= B"


# test/bench presets (decomposition_parameters.rs:50-113)
DP_GOLDILOCKS = DecompositionParams(B=1 << 15, L=5, b=2, K=15)
DP_BABYBEAR = DecompositionParams(B=1 << 8, L=4, b=2, K=8)
DP_FROG = DecompositionParams(B=1 << 8, L=8, b=2, K=10)
DP_STARK = DecompositionParams(B=10485760000, L=8, b=320, K=4)
DP_STARK_FOLDING = DecompositionParams(B=3010936384, L=8, b=38, K=6)
# Foldable Stark preset: the reference's StarkDP (b=320) implies a degree-640
# folding sumcheck, infeasible on any backend — its own Stark e2e tests are
# #[ignore]d for this reason (nifs/tests.rs:139-148). Choosing b=2 from the
# same b^K >= B grid keeps the sumcheck at degree 4 (more, smaller folded
# instances: K=32), making Stark end-to-end folding actually runnable.
DP_STARK_E2E = DecompositionParams(B=1 << 32, L=8, b=2, K=32)
# moderate-b point from the same b^K >= B grid (16^4 = 2^16 >= 2^15): a
# degree-32 folding sumcheck with only K=4 decomposed instances per side.
# Runnable here thanks to the balanced product-tree range comb
# (nifs/folding.py — the reference evaluates the degree-2b product as a
# sequential chain, folding/utils.rs:306-317).
DP_GOLDILOCKS_B16 = DecompositionParams(B=1 << 15, L=5, b=16, K=4)
# small params for fast tests (reference test_params::DP)
DP_TEST = DecompositionParams(B=1024, L=2, b=2, K=10)
DP_TEST_L1 = DecompositionParams(B=1024, L=1, b=2, K=10)

PRESETS = {
    "goldilocks": DP_GOLDILOCKS,
    "babybear": DP_BABYBEAR,
    "frog": DP_FROG,
    "stark": DP_STARK,
}


def calculate_bound_l2(d: int, kappa: int, log2_q: float) -> float:
    """B_{L2} = 2^(2*sqrt(log2(delta) * d * kappa * log2 q)), delta = 1.0045
    (security_check.rs:5-16)."""
    log2_delta = math.log2(1.0045)
    return 2.0 ** (2.0 * math.sqrt(log2_delta * d * kappa * log2_q))


def check_ring_modulus_128_bits_security(
    q: int, d: int, kappa: int, wit_len: int, B: int, L: int
) -> bool:
    """MSIS 128-bit security predicate (security_check.rs:22-45):
    the infinity bound B must satisfy B < B_{L2}/sqrt(d * wit_len * L)
    and the decomposition must cover the modulus: B^L > q."""
    log2_q = math.log2(q)
    b_l2 = calculate_bound_l2(d, kappa, log2_q)
    b_inf = b_l2 / math.sqrt(d * wit_len * L)
    return B < b_inf and B**L > q


def find_l(q: int, B: int) -> int:
    """Smallest L with B^L > q (bounds.sage:9-27)."""
    L, acc = 1, B
    while acc <= q:
        acc *= B
        L += 1
    return L


def enumerate_b_k(B: int):
    """All (b, k) with b^k == B, b >= 2, k >= 1 (bounds.sage:34-42)."""
    out = []
    for k in range(1, B.bit_length() + 1):
        b = round(B ** (1.0 / k))
        for cand in (b - 1, b, b + 1):
            if cand >= 2 and cand**k == B:
                out.append((cand, k))
    return sorted(set(out))
