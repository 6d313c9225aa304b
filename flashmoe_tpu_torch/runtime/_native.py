"""Build and load the port's native host library: the token loader.

Counterpart of ``flashmoe_tpu/parallel/_native.py:1-111``, for the port's
own copy of the loader (``flashmoe_tpu_torch/csrc/host/dataloader.cpp``).
One ``g++ -O2 -shared -fPIC`` builds it at first use into
``flashmoe_tpu_torch/kernels/build/`` (ignored by git), rebuilt when the
source is newer than the library, under a lock; the library is written
under a private name and renamed into place, so a concurrent process never
loads a half-written one.  Without ``g++`` :func:`load` returns None and
:class:`~flashmoe_tpu_torch.runtime.data.TokenLoader` takes its NumPy arm,
as JAX's does.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "host", "dataloader.cpp")
BUILD_DIR = os.path.join(_PKG, "kernels", "build")
LIB = os.path.join(BUILD_DIR, "libflashmoe_host.so")

_lock = threading.Lock()
_lib = None
_tried = False


def build(force: bool = False) -> str | None:
    """Compile the loader unless the library is newer than its source;
    returns the library's path, or None when ``g++`` is missing or
    fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    if (not force and os.path.exists(LIB)
            and os.path.getmtime(LIB) >= os.path.getmtime(SOURCE)):
        return LIB
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
           "-o", tmp, SOURCE]
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
    needed), or None when it cannot be built or loaded."""
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
        except OSError:
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
        _lib = lib
        return _lib
