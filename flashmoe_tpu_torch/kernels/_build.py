"""Build and load the port's CUDA kernels.

Every ``.cu`` source under ``flashmoe_tpu_torch/csrc/`` is compiled for
``sm_90a`` by its own ``nvcc -c``, all started together, and one more
``nvcc`` links the objects into a shared library with a plain C interface,
loaded with ``ctypes``.  The build happens at first use, into
``flashmoe_tpu_torch/kernels/build/<hash>/`` (ignored by git), keyed by a
hash of the sources and flags, so a fresh checkout builds its kernels the
first time a CUDA tensor asks for one.  A missing or failing ``nvcc``
raises: there is no fallback.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build")
LIB_NAME = "libflashmoe_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int

# C signatures: name -> argtypes (restype is always int, a cudaError_t)
SIGNATURES = {
    # dtype_is_bf16, x, w, S, H, E, K, split, z_coef, bias_e, bias,
    # scratch, tickets, combine, idx, counts, probs_mean, aux, z, stream
    "fm_gate": [I, P, P, I, I, I, I, I, ctypes.c_float, I, ctypes.c_float,
                P, P, P, P, P, P, P, P, P],
    # dtype_is_bf16, gated, act, x, tile_gid, block_m, num_rows, w_up,
    # w_gate, b_up, w_down, b_down, hidden, out, plan, T, H, I, E, grid,
    # stream
    "fm_grouped_ffn": [I, I, I, P, P, I, P, P, P, P, P, P, P, P, P, I, I, I,
                       I, I, P],
    # dtype_is_bf16, x, w, S, H, E, PX, K, logits, m, se, top_p, top_i,
    # stream
    "fm_gate_pass1": [I, P, P, I, I, I, I, I, P, P, P, P, P, P],
    # logits, m, se, top_i, S, E, K, part_probs, part_counts, part_z,
    # tickets, probs_sum, counts, zsum, stream
    "fm_gate_pass2": [P, P, P, P, I, I, I, P, P, P, P, P, P, P, P],
    # dtype_is_bf16, gated, act, x, src_tok, tile_gid, block_m, num_rows,
    # w_up, w_gate, b_up, w_down, b_down, hidden, out, plan, T, H, I, E,
    # grid, stream
    "fm_grouped_ffn_tokens": [I, I, I, P, P, P, I, P, P, P, P, P, P, P, P,
                              P, I, I, I, I, I, P],
    # a, b, c, K, N, stream
    "fm_hopper_tile_mn": [P, P, P, I, I, P],
    # dtype_is_bf16, gated, act, x, tile_gid, block_m, num_rows, w_up,
    # w_gate, b_up, w_down, b_down, u, g, hidden, out, plan, T, H, I, E,
    # grid, stream
    "fm_grouped_ffn_res": [I, I, I, P, P, I, P, P, P, P, P, P, P, P, P, P, P,
                           I, I, I, I, I, P],
    # transpose_w, x, tile_gid, block_m, num_rows, w, out, T, K, N, stream
    # (f32)
    "fm_grouped_matmul": [I, P, P, I, P, P, P, I, I, I, P],
    # transpose_w, out_f32, x, tile_gid, block_m, num_rows, w, out, plan,
    # T, K, N, E, grid, stream (bf16)
    "fm_grouped_matmul_hopper": [I, I, P, P, I, P, P, P, P, I, I, I, I, I,
                                 P],
    # dtype_is_bf16, x, dy, row_start, row_end, dw, T, E, K, N, grid,
    # stream
    "fm_tgmm": [I, P, P, P, P, P, I, I, I, I, I, P],
    # form, a, b, c, K, N, stream
    "fm_hopper_check": [I, P, P, P, I, I, P],
    # dtype_is_bf16, q, k, v, o, B, N, NKV, T, D, scale, causal, stream
    "fm_flash_attention": [I, P, P, P, P, I, I, I, I, I, ctypes.c_float, I,
                           P],
    # dtype_is_bf16, gated, weight code, out (int*)
    "fm_fused_ep_max_blocks": [I, I, I, ctypes.POINTER(I)],
    # dtype_is_bf16, gated, weight code, act, D, nlx, cap, ch, H, I, k,
    # combine, rows_pad, G, n_total, seq, work_base, timeout_ns, x_send,
    # send_cnt, order, recv_pos, w_sorted, w_up, w_gate, b_up, w_down,
    # b_down, s_up, s_gate, s_down, peers, host_peers, maps, out, stream
    "fm_fused_ep": [I, I, I, I, I, I, I, I, I, I, I, I, I, I, I,
                    ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_longlong, P,
                    P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P],
}


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "flashmoe_tpu_torch cannot be built")


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the sources unless this exact build exists; return the
    library's path."""
    srcs = _sources()
    out_dir = os.path.join(BUILD_ROOT, _digest(srcs))
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    # build in a private directory, then rename the library into place: a
    # concurrent build never loads a half-written one
    work = tempfile.mkdtemp(dir=out_dir)
    objs, procs = [], []
    try:
        nvcc = _nvcc()
        for src in (s for s in srcs if s.endswith(".cu")):
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for cmd, proc in procs:
            _finish(cmd, proc)
        tmp = os.path.join(work, LIB_NAME)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        _finish(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
        os.replace(tmp, lib)
    finally:
        for _, proc in procs:  # after a failure, stop the other compiles
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(work, ignore_errors=True)
    return lib


def _finish(cmd: list[str], proc: subprocess.Popen) -> None:
    """Wait for one nvcc; raise with its output if it failed."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}\n{err}")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one
    device, 16-byte aligned (the kernels load 16 bytes at a time)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on {dev}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when ``name`` is called with grad enabled on an input that
    requires grad: a kernel's output carries no ``grad_fn``, so the
    gradient would be cut without a word.  Under autograd the kernels are
    reached through their ``torch.autograd.Function``s (``grouped_ffn_ad``,
    ``grouped_ffn_tokens_ad``, ``router``), whose forward and backward run
    with grad disabled."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: called under autograd on an input that requires "
            f"grad; the kernel's output would carry no gradient.  "
            f"Differentiate through grouped_ffn_ad / router, or call it "
            f"under torch.no_grad()")


def use_kernels_for(t: torch.Tensor, use_kernels: bool | None) -> bool:
    """Resolve an entry point's ``use_kernels`` argument: ``None`` means
    the kernels for a CUDA tensor and the plain versions for a CPU one;
    ``True`` with a CPU tensor raises."""
    if use_kernels is None:
        return t.is_cuda
    if use_kernels and not t.is_cuda:
        raise ValueError(
            f"use_kernels=True needs CUDA tensors, got a tensor on "
            f"{t.device}: the CUDA kernels have no CPU version")
    return bool(use_kernels)
