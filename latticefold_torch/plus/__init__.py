"""LatticeFold+ (eprint 2025/247) in PyTorch.

The counterpart of the JAX package's ``plus`` package, module for module:
monomial set check (setchk), double-commitment range check (rgchk),
commitment transformation (cm), mlin/lin folding, the B^2 -> 2xB
decomposition step (decomp), the committed R1CS frontend (r1cs), and the
accumulator-style prover/verifier (plus). Power-of-two cyclotomics only
(Frog, Stark), in the coefficient semantics of the reference's CoeffRing,
with bulk data in NTT form in tensors. Its kernels are the fold's: the CRT
(``rings/ops.py``) and the Ajtai commit (``AjtaiScheme.commit_batch``).
"""

from .mlin import LinB, LinB2, LinBX, LinParameters, Mlin, lin
from .plus import PlusParameters, PlusProof, PlusProver, PlusVerifier, estimate_bound
from .r1cs import ComR1CS, ComR1CSProof, linearize, verify_linearization
from .rgchk import DecompParameters, Rg, RgInstance
from .transcript import PlusTranscript

__all__ = [
    "ComR1CS",
    "ComR1CSProof",
    "DecompParameters",
    "LinB",
    "LinB2",
    "LinBX",
    "LinParameters",
    "Mlin",
    "PlusParameters",
    "PlusProof",
    "PlusProver",
    "PlusVerifier",
    "PlusTranscript",
    "Rg",
    "RgInstance",
    "estimate_bound",
    "lin",
    "linearize",
    "verify_linearization",
]
