"""latticefold_torch: the LatticeFold NIFS prover in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``latticefold_tpu`` that imports nothing of it: same module names,
same array layouts at public functions (NTT form ``[..., ncomp, e, nl]``
Montgomery limbs with R = 2^(32 nl), coefficient form ``[..., d, nl]``), so
each function has a counterpart there. Limbs are held in int64 tensors
(see ``modops``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise.

Kernels (``csrc/``, built at first use by ``cuda.py``):

    crt_tc_kernel.cu          CRT / ICRT on u8 tensor cores       (rings/ops.py)
    crt_kernel.cu             CRT / ICRT on CUDA cores, the former (rings/ops.py)
    plane_dot_sm90_kernel.cu  byte-plane commit dot, wgmma + TMA, and
                              its probe modes (K-major, dot only) (rings/plane_commit.py)
    plane_epilogue_diag_kernel.cu  byte-plane commit epilogue, a
                              lane per patch diagonal             (rings/plane_commit.py)
    plane_epilogue_kernel.cu  the same, a thread per item, the former
    plane_dot_kernel.cu       byte-plane dot on mma.sync: planes
                              only, and the former of the others  (rings/plane_commit.py)
    commit_sm90_kernel.cu     Ajtai commitment contraction, staged
                              whole rows and lazy lane sums       (rings/mxu.py)
    commit_kernel.cu          the same, a thread per pair, the former
    int_gemm_sm90_kernel.cu   the probes' s8 / u8 GEMM, wgmma     (rings/plane_probes.py)
    int_gemm_kernel.cu, probe_kernels.cu  the other TPU probes, and
                              the GEMM's former                   (rings/plane_probes.py)

Public surface:

    rings.construct.get_ring   -- the four cyclotomic ring presets
    arith                      -- CCS/R1CS/CCCS/LCCCS, Witness
    commitment.AjtaiScheme     -- Module-SIS commitments (commit kernel)
    transcript.Transcript      -- Fiat-Shamir (Poseidon)
    nifs                       -- LatticeFold NIFS prove/verify
    convert                    -- numpy arrays -> the port's tensors/objects
"""

__version__ = "0.1.0"

from .rings.construct import get_ring  # noqa: F401  (primary entry point)
