"""Security-parameter grid generation (the bounds.sage port).

Mirror of notebooks/bounds.sage:5-58 (which generates
benches/config.toml): for each ring and witness size n, find the largest
power-of-two infinity bound B below the 128-bit MSIS L2 bound
(B_2 = 2^(2 sqrt(log2(1.0045) d kappa log2 q)), bounds.sage:5-7;
security_check.rs:5-16), the smallest L with B^L > q (bounds.sage:9-27), and
every (b, K) splitting with b^K = B (bounds.sage:34-42).

Run ``python -m latticefold_torch.paramgen`` to emit the JSON grid (the
reference's config.toml analogue) for all four rings.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass
from typing import List, Optional

from .params import (
    DecompositionParams,
    calculate_bound_l2,
    check_ring_modulus_128_bits_security,
    enumerate_b_k,
    find_l,
)
from .rings.construct import get_ring

RING_KAPPAS = {
    # kappa search ranges follow the reference's config grids
    # (benches/config.toml:2-37 uses per-(ring, n) kappa picks)
    "goldilocks": range(2, 24),
    "babybear": range(2, 30),
    "stark": range(2, 16),
    "frog": range(2, 24),
}


@dataclass
class ParamRow:
    ring: str
    n: int  # witness length (pre-decomposition)
    kappa: int
    B: int
    L: int
    b: int
    K: int

    def dp(self) -> DecompositionParams:
        return DecompositionParams(B=self.B, L=self.L, b=self.b, K=self.K)


def find_params(
    ring_name: str, n: int, kappa: int
) -> Optional[List[ParamRow]]:
    """All secure (B, L, b, K) rows for one (ring, n, kappa) (bounds.sage
    main loop)."""
    ring = get_ring(ring_name)
    q, d = ring.q, ring.d
    log2q = math.log2(q)
    b2 = calculate_bound_l2(d, kappa, log2q)
    b_inf_limit = b2 / math.sqrt(d * n * 1)  # L refined below per candidate
    if b_inf_limit <= 2:
        return None
    rows = []
    # largest power-of-two B under the limit, then walk down a few steps
    bexp = int(math.floor(math.log2(b_inf_limit)))
    for be in range(bexp, max(bexp - 8, 0), -1):
        B = 1 << be
        L = find_l(q, B)
        if not check_ring_modulus_128_bits_security(q, d, kappa, n, B, L):
            continue
        for b, K in enumerate_b_k(B):
            if b < 2:
                continue
            rows.append(ParamRow(ring=ring_name, n=n, kappa=kappa, B=B, L=L, b=b, K=K))
    return rows or None


def generate_grid(
    rings=("goldilocks", "babybear", "stark", "frog"),
    n_range=tuple(1 << e for e in range(9, 16)),
) -> List[dict]:
    """The full config grid (bounds.sage:45-58). ``n_range``'s default is a
    tuple, so that every call sees the whole range (a generator default
    would be spent by the first call)."""
    out = []
    ns = list(n_range)
    for ring_name in rings:
        for n in ns:
            for kappa in RING_KAPPAS[ring_name]:
                rows = find_params(ring_name, n, kappa)
                if rows:
                    # largest-B row per kappa (the per-kappa picks of
                    # config.toml; higher kappa buys a bigger B)
                    best = max(rows, key=lambda r: (r.B, -r.K))
                    out.append(asdict(best))
    return out


def main():
    grid = generate_grid()
    print(json.dumps(grid, indent=1))


if __name__ == "__main__":
    main()
