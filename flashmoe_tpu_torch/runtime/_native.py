"""Build and load the port's native host library: the token loader and
the Decider.

Counterpart of ``flashmoe_tpu/parallel/_native.py:1-111``, for the port's
own copies of the host sources (``flashmoe_tpu_torch/csrc/host/
dataloader.cpp`` and ``decider.cpp``).  One ``g++ -O2 -shared -fPIC``
builds both into one library at first use, into
``flashmoe_tpu_torch/kernels/build/`` (ignored by git), rebuilt when a
source is newer than the library, under a lock; the library is written
under a private name and renamed into place, so a concurrent process
never loads a half-written one.  Without ``g++`` :func:`load` returns
None: :class:`~flashmoe_tpu_torch.runtime.data.TokenLoader` takes its
NumPy arm and :func:`native_decide` returns None (the Decider's Python
arm), as JAX's do.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_PKG, "csrc", "host", f)
                for f in ("dataloader.cpp", "decider.cpp"))
BUILD_DIR = os.path.join(_PKG, "kernels", "build")
LIB = os.path.join(BUILD_DIR, "libflashmoe_host.so")
#: the decider's ``flashmoe_native_abi_version``
_ABI_VERSION = 1

_lock = threading.Lock()
_lib = None
_tried = False


def build(force: bool = False) -> str | None:
    """Compile the library unless it is newer than every source; returns
    its path, or None when ``g++`` is missing or fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    if (not force and os.path.exists(LIB)
            and os.path.getmtime(LIB) >= max(os.path.getmtime(s)
                                             for s in SOURCES)):
        return LIB
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
           "-o", tmp, *SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIB


def load():
    """The loaded library with its C signatures bound (building it if
    needed), or None when it cannot be built or loaded, or its decider's
    ABI version is not this loader's."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            if lib.flashmoe_native_abi_version() != _ABI_VERSION:
                return None
        except (OSError, AttributeError):
            return None
        lib.flashmoe_loader_open.restype = ctypes.c_void_p
        lib.flashmoe_loader_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_int]
        lib.flashmoe_loader_next.restype = ctypes.c_int
        lib.flashmoe_loader_next.argtypes = [ctypes.c_void_p,
                                             ctypes.c_void_p]
        lib.flashmoe_loader_num_windows.restype = ctypes.c_int64
        lib.flashmoe_loader_num_windows.argtypes = [ctypes.c_void_p]
        lib.flashmoe_loader_close.restype = None
        lib.flashmoe_loader_close.argtypes = [ctypes.c_void_p]
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
        lib.flashmoe_decide.restype = ctypes.c_int
        lib.flashmoe_decide.argtypes = [
            ctypes.c_int, f64, f64, f64, f64, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, i32, i32]
        _lib = lib
        return _lib


def native_decide(alpha, beta, throughput, memory_gb, num_experts,
                  expert_mb, act_mb, grad_mb, gamma, is_training):
    """Run the C++ decider: ``(group_ids [n], expert_counts [n])``, or
    None when the library is unavailable or the call fails."""
    lib = load()
    if lib is None:
        return None
    n = alpha.shape[0]
    alpha = np.ascontiguousarray(alpha, np.float64)
    beta = np.ascontiguousarray(beta, np.float64)
    thr = np.ascontiguousarray(throughput, np.float64)
    mem = np.ascontiguousarray(memory_gb, np.float64)
    gid = np.zeros((n,), np.int32)
    cnt = np.zeros((n,), np.int32)
    rc = lib.flashmoe_decide(
        n, alpha, beta, thr, mem, int(num_experts), float(expert_mb),
        float(act_mb), float(grad_mb), float(gamma), int(bool(is_training)),
        gid, cnt)
    if rc != 0:
        return None
    return gid, cnt
