"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded with ``ctypes``. Builds happen at first use, one
``nvcc`` process per source, all started together, into
``latticefold_torch/_build/`` (listed in ``.gitignore``); a library is
rebuilt when any source or header is newer than it.

Every launcher returns the ``cudaGetLastError`` code of its launches and the
wrappers raise when it is not 0. ``LAUNCHES`` counts launches per kernel
(and ``PERMUTATIONS`` the Poseidon kernels' permutations): the wrappers in
``rings/ops.py``, ``rings/mxu.py``, ``rings/plane_commit.py``,
``rings/plane_probes.py`` and ``transcript/device.py`` add one where they
launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# library name -> source file
SOURCES = {
    "crt": "crt_kernel.cu",
    "crt_tc": "crt_tc_kernel.cu",
    "commit": "commit_kernel.cu",
    "commit_sm90": "commit_sm90_kernel.cu",
    "plane_dot": "plane_dot_kernel.cu",
    "plane_dot_sm90": "plane_dot_sm90_kernel.cu",
    "plane_epilogue": "plane_epilogue_kernel.cu",
    "plane_epilogue_diag": "plane_epilogue_diag_kernel.cu",
    "int_gemm": "int_gemm_kernel.cu",
    "int_gemm_sm90": "int_gemm_sm90_kernel.cu",
    "bf16_gemm_sm90": "bf16_gemm_sm90_kernel.cu",
    "probe": "probe_kernels.cu",
    "poseidon_kernel": "poseidon_kernel.cu",  # not "poseidon": native/ builds libposeidon.so here
}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U64P = ctypes.POINTER(ctypes.c_uint64)
# kernel name -> (library, C function, argument types)
_ARGTYPES = {
    "crt": ("crt", "lf_crt_apply", [_P] * 3 + [_I] * 3 + [_U64P, _P]),
    "crt_tc": ("crt_tc", "lf_crt_tc", [_P] * 3 + [_I] * 3 + [_U64P, _P]),
    "commit": ("commit", "lf_ajtai_commit", [_P] * 5 + [_I] * 9 + [_U64P, _P]),
    "commit_sm90": ("commit_sm90", "lf_commit_sm90", [_P] * 5 + [_I] * 17 + [_U64P, _P]),
    "plane_dot": ("plane_dot", "lf_plane_dot", [_P, _LL, _LL, _P, _LL, _LL, _I, _P] + [_I] * 8 + [_P]),
    "plane_dot_sm90": ("plane_dot_sm90", "lf_plane_dot_sm90", [_P, _LL, _LL, _P, _LL, _LL, _I, _P] + [_I] * 8 + [_P]),
    "plane_epilogue": ("plane_epilogue", "lf_plane_epilogue", [_P] * 4 + [_I] * 11 + [_U64P, _P]),
    "plane_epilogue_diag": ("plane_epilogue_diag", "lf_plane_epilogue_diag", [_P] * 4 + [_I] * 12 + [_U64P, _P]),
    "int_gemm": ("int_gemm", "lf_int_gemm", [_P, _LL, _P, _LL, _P, _LL] + [_I] * 6 + [_P]),
    "int_gemm_sm90": ("int_gemm_sm90", "lf_int_gemm_sm90", [_P, _LL, _P, _LL, _P] + [_I] * 6 + [_P] * 3),
    "bf16_gemm_sm90": ("bf16_gemm_sm90", "lf_bf16_gemm_sm90", [_P, _LL, _P, _LL, _P] + [_I] * 3 + [_P]),
    "dma_checksum": ("probe", "lf_dma_checksum", [_P, _LL, _P, _LL, _P, _I, _I, _P]),
    "bitcast": ("probe", "lf_bitcast_u8", [_P, _LL, _P, _P]),
    "merge": ("probe", "lf_merge_minor", [_P, _I, _I, _I, _P, _P]),
    "bitcast_v1": ("probe", "lf_bitcast_u8_v1", [_P, _LL, _P, _P]),
    "merge_v1": ("probe", "lf_merge_minor_v1", [_P, _I, _I, _I, _P, _P]),
    "poseidon": ("poseidon_kernel", "lf_poseidon_sponge", [_P] * 5 + [_I] * 9 + [_U64P, _P]),
    "poseidon_perm": ("poseidon_kernel", "lf_poseidon", [_P, _P, _I, _I, _P, _P, _P] + [_I] * 4 + [_U64P, _P]),
}

LAUNCHES = {name: 0 for name in _ARGTYPES}
# permutations run by the Poseidon kernels' launches (the sponge kernel runs
# a whole absorb or squeeze call, several permutations, in one launch)
PERMUTATIONS = {"poseidon": 0, "poseidon_perm": 0}
BUILD_LOG: dict = {}  # library name -> nvcc's output (ptxas resource usage)

_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}


def reset_launches():
    for counts in (LAUNCHES, PERMUTATIONS):
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not os.path.exists(out):
        return True
    deps = [os.path.join(CSRC, f) for f in os.listdir(CSRC)]
    return os.path.getmtime(out) < max(os.path.getmtime(p) for p in deps)


def build(names=None) -> dict:
    """Compile the stale kernels in parallel; returns {name: seconds}."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
            "-o", tmp, os.path.join(CSRC, SOURCES[name]),
        ]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    seconds = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            os.remove(tmp)
            failed.append(f"{SOURCES[name]}:\n{out}")
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def kernel(name: str):
    """The ctypes function of kernel ``name``, building its library if needed."""
    with _lock:
        if name not in _fns:
            lib_name, fn_name, argtypes = _ARGTYPES[name]
            if lib_name not in _libs:
                build([lib_name])
                _libs[lib_name] = ctypes.CDLL(lib_path(lib_name))
            fn = getattr(_libs[lib_name], fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return _fns[name]


def check(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: cudaError {code}")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _words(x: int, n: int) -> list:
    return [(x >> (64 * i)) & ((1 << 64) - 1) for i in range(n)]


@functools.lru_cache(maxsize=None)
def field_constants(q: int, nl: int):
    """The u64 words that the field type of limb width ``nl`` reads (``from``
    in csrc/field32.cuh, field64.cuh, field256.cuh), as the ctypes array a
    launcher takes."""
    if nl == 1:  # q, -q^-1 mod 2^32, 2^64 mod q, 2^-32 mod q
        words = [q, (-pow(q, -1, 1 << 32)) % (1 << 32), (1 << 64) % q, pow(1 << 32, -1, q)]
    elif nl == 2:  # q, -q^-1 mod 2^64, 2^64 mod q, 2^128 mod q
        words = [q, (-pow(q, -1, 1 << 64)) % (1 << 64), (1 << 64) % q, (1 << 128) % q]
    elif nl == 8:  # q, -q^-1 mod 2^64, 2^256 mod q, 2^512 mod q
        words = (
            _words(q, 4) + [(-pow(q, -1, 1 << 64)) % (1 << 64)]
            + _words((1 << 256) % q, 4) + _words((1 << 512) % q, 4)
        )
    else:
        raise NotImplementedError(f"CUDA kernels: no field type for nl={nl} (built for nl = 1, 2, 8)")
    return (ctypes.c_uint64 * len(words))(*words)


def require_tensor(t, name: str, device):
    if t.device != device or t.dtype != torch.int64 or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous int64 tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
