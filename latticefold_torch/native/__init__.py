"""Native (C++) host-runtime components, loaded via ctypes.

Currently: the Poseidon sponge engine for <=64-bit prime fields (the
Fiat-Shamir transcript is inherently sequential host work). The library is
built with ``g++`` at first use into ``latticefold_torch/_build/`` (listed in
``.gitignore``). Falls back to the pure-Python sponge when the toolchain is
unavailable; both backends are bit-identical.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libposeidon.so")
_SRC_PATH = os.path.join(_HERE, "poseidon.cpp")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    """Compile into a temporary name and rename it into place, so concurrent
    test workers never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC_PATH],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib():
    """Returns the ctypes library handle, building it on first use; None if
    the native backend is unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.lf_sponge_new.restype = ctypes.c_void_p
        lib.lf_sponge_new.argtypes = [
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.lf_sponge_free.argtypes = [ctypes.c_void_p]
        lib.lf_sponge_absorb.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int
        ]
        lib.lf_sponge_squeeze.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int
        ]
        lib.lf_sponge_clone.restype = ctypes.c_void_p
        lib.lf_sponge_clone.argtypes = [ctypes.c_void_p]
        lib.lf_sponge_get_state.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.lf_sponge_set_state.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return _lib


class NativeSponge:
    """ctypes wrapper with the same interface as poseidon.PoseidonSponge."""

    def __init__(self, cfg, lib):
        self.cfg = cfg
        self._lib = lib
        t = cfg.rate + cfg.capacity
        ark_flat = (ctypes.c_uint64 * ((cfg.full_rounds + cfg.partial_rounds) * t))(
            *[v for row in cfg.ark for v in row]
        )
        mds_flat = (ctypes.c_uint64 * (t * t))(*[v for row in cfg.mds for v in row])
        self._h = lib.lf_sponge_new(
            cfg.q, cfg.rate, cfg.capacity, cfg.full_rounds, cfg.partial_rounds,
            cfg.alpha, ark_flat, mds_flat,
        )

    def __del__(self):
        try:
            self._lib.lf_sponge_free(self._h)
        except Exception:
            pass

    def absorb(self, elements):
        n = len(elements)
        if n == 0:
            return
        buf = (ctypes.c_uint64 * n)(*[int(e) % self.cfg.q for e in elements])
        self._lib.lf_sponge_absorb(self._h, buf, n)

    def squeeze_native(self, n: int):
        if n == 0:
            return []
        out = (ctypes.c_uint64 * n)()
        self._lib.lf_sponge_squeeze(self._h, out, n)
        return list(out)

    def snapshot(self):
        t = self.cfg.rate + self.cfg.capacity
        st = (ctypes.c_uint64 * t)()
        idx = ctypes.c_int()
        absorbing = ctypes.c_int()
        self._lib.lf_sponge_get_state(
            self._h, st, ctypes.byref(idx), ctypes.byref(absorbing)
        )
        return list(st), idx.value, bool(absorbing.value)

    def restore(self, state_ints, index: int, absorbing: bool):
        t = self.cfg.rate + self.cfg.capacity
        st = (ctypes.c_uint64 * t)(*[int(v) % self.cfg.q for v in state_ints])
        self._lib.lf_sponge_set_state(self._h, st, index, 1 if absorbing else 0)

    def squeeze_bytes(self, n: int) -> bytes:
        cfg = self.cfg
        usable = (cfg.q.bit_length() - 1) // 8
        nelems = -(-n // usable)
        elems = self.squeeze_native(nelems)
        nbytes_per = ((cfg.q.bit_length() + 63) // 64) * 8
        buf = b"".join(e.to_bytes(nbytes_per, "little")[:usable] for e in elems)
        return buf[:n]
