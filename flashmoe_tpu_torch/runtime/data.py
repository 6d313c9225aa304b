"""Training input: binary token shards, read ahead on a host thread.

Counterpart of ``flashmoe_tpu/runtime/data.py``.  Native arm: the port's
C++ loader (``csrc/host/dataloader.cpp``, built by
:mod:`flashmoe_tpu_torch.runtime._native`) cuts and shuffles [batch,
seq_len + 1] windows on a background thread.  NumPy arm: the same windows
in the same xorshift order, so both arms yield the same batches for the
same seed, and JAX's loader yields them too.

Batches land on the loader's ``device`` (the card by default).  On the
card each batch is copied through one of two pinned host buffers with
``non_blocking=True``; a buffer is filled again only after the event
recorded behind its copy has completed.
"""

from __future__ import annotations

import numpy as np
import torch

from flashmoe_tpu_torch.runtime import _native


def write_token_file(path: str, tokens: np.ndarray):
    """Write a flat int32 little-endian token stream."""
    np.asarray(tokens, dtype="<i4").tofile(path)


def _xorshift_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The C++ loader's epoch shuffle, replicated exactly."""
    s = (seed + 0x51ED270B * (epoch + 1)) & 0xFFFFFFFFFFFFFFFF
    if s == 0:
        s = 0x9E3779B97F4A7C15

    def nxt():
        nonlocal s
        s ^= (s << 13) & 0xFFFFFFFFFFFFFFFF
        s ^= s >> 7
        s ^= (s << 17) & 0xFFFFFFFFFFFFFFFF
        return s

    order = np.arange(n, dtype=np.int64)
    for i in range(n - 1, 0, -1):
        j = nxt() % (i + 1)
        order[i], order[j] = order[j], order[i]
    return order


class TokenLoader:
    """Iterator of ``{"tokens": int32 [batch, seq_len + 1]}`` batches on
    ``device``.  ``native``: ``"auto"`` takes the C++ loader when it
    builds, ``True`` requires it, ``False`` takes the NumPy arm."""

    def __init__(self, path: str, batch: int, seq_len: int, *,
                 seed: int = 0, shuffle: bool = True,
                 native: str | bool = "auto", device="cuda"):
        self.path, self.batch, self.seq_len = path, batch, seq_len
        self.seed, self.shuffle = seed, shuffle
        self.device = torch.device(device)
        self._handle = None
        self._lib = None
        self._closed = False
        # rows handed out by the native loader (its C API has no cursor;
        # both arms consume windows in one order, so a row count is one)
        self._native_rows = 0
        if native is not False:
            lib = _native.load()
            if lib is not None:
                h = lib.flashmoe_loader_open(path.encode(), seq_len, batch,
                                             seed, int(shuffle))
                if h:
                    self._handle, self._lib = h, lib
                elif native is True:
                    raise RuntimeError(f"native loader failed to open {path}")
            elif native is True:
                raise RuntimeError("native library unavailable")
        if self._handle is None:
            toks = np.fromfile(path, dtype="<i4")
            w = seq_len + 1
            n = len(toks) // w
            if n < 1:
                raise ValueError(f"{path}: fewer tokens than one window")
            self._windows = toks[: n * w].reshape(n, w)
            self._epoch = 0
            self._cursor = 0
            self._order = (_xorshift_order(n, seed, 0) if shuffle
                           else np.arange(n, dtype=np.int64))
        # (pinned host buffer, event of its last copy) pairs, in turn
        self._staging: list = []
        self._turn = 0

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    @property
    def num_windows(self) -> int:
        if self._handle is not None:
            return int(self._lib.flashmoe_loader_num_windows(self._handle))
        return len(self._windows)

    def __iter__(self):
        return self

    def _host_buffer(self) -> tuple[np.ndarray, object]:
        """The next staging slot as (numpy view, its slot): pinned memory
        whose previous copy has completed on the card, or a fresh array
        for a CPU loader."""
        shape = (self.batch, self.seq_len + 1)
        if self.device.type != "cuda":
            return np.empty(shape, np.int32), None
        if len(self._staging) < 2:
            self._staging.append([torch.empty(shape, dtype=torch.int32,
                                              pin_memory=True), None])
        slot = self._staging[self._turn % len(self._staging)]
        self._turn += 1
        if slot[1] is not None:
            slot[1].synchronize()  # the buffer's last copy has landed
        return slot[0].numpy(), slot

    def _to_device(self, host: np.ndarray, slot) -> torch.Tensor:
        if slot is None:
            return torch.from_numpy(host).to(self.device)
        out = slot[0].to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(torch.cuda.current_stream(self.device))
        return out

    def __next__(self):
        if self._closed:
            raise RuntimeError("loader is closed")
        host, slot = self._host_buffer()
        if self._handle is not None:
            rc = self._lib.flashmoe_loader_next(self._handle,
                                                host.ctypes.data)
            if rc != 0:
                raise StopIteration
            self._native_rows += self.batch
            return {"tokens": self._to_device(host, slot)}
        for b in range(self.batch):
            if self._cursor >= len(self._order):
                self._epoch += 1
                self._cursor = 0
                if self.shuffle:
                    self._order = _xorshift_order(
                        len(self._windows), self.seed, self._epoch)
            host[b] = self._windows[self._order[self._cursor]]
            self._cursor += 1
        return {"tokens": self._to_device(host, slot)}

    # ------------------------------------------------------------------
    # Resumable state
    # ------------------------------------------------------------------

    def _consumed_rows(self) -> int:
        """Windows handed out since epoch 0: the canonical cursor."""
        if self._handle is not None:
            return self._native_rows
        return self._epoch * len(self._windows) + self._cursor

    def state_dict(self) -> dict:
        """The loader's position, the same on both arms (and JAX's):
        (epoch, cursor) with ``cursor < num_windows``."""
        if self._closed:
            raise RuntimeError("loader is closed")
        n = self.num_windows
        consumed = self._consumed_rows()
        return {"epoch": consumed // n, "cursor": consumed % n,
                "seed": self.seed, "shuffle": bool(self.shuffle)}

    def load_state_dict(self, state: dict) -> None:
        """Reposition so that the next batch is the one a loader in
        ``state`` would yield next; ``seed`` and ``shuffle`` come from the
        state.  The native arm reopens and skips whole batches (its C API
        has no seek), so it resumes only on a batch boundary."""
        if self._closed:
            raise RuntimeError("loader is closed")
        n = self.num_windows
        epoch, cursor = int(state["epoch"]), int(state["cursor"])
        if not 0 <= cursor < max(n, 1):
            raise ValueError(
                f"loader state cursor {cursor} out of range for "
                f"{n} windows in {self.path}")
        self.seed = int(state.get("seed", self.seed))
        self.shuffle = bool(state.get("shuffle", self.shuffle))
        consumed = epoch * n + cursor
        if self._handle is not None:
            if consumed % self.batch:
                raise ValueError(
                    f"native loader can only resume on a batch boundary: "
                    f"{consumed} rows consumed, batch={self.batch}; "
                    f"reopen with native=False to resume mid-batch")
            self._lib.flashmoe_loader_close(self._handle)
            self._handle = self._lib.flashmoe_loader_open(
                self.path.encode(), self.seq_len, self.batch, self.seed,
                int(self.shuffle))
            if not self._handle:
                raise RuntimeError(
                    f"native loader failed to reopen {self.path}")
            self._native_rows = 0
            scratch = np.empty(self.batch * (self.seq_len + 1), np.int32)
            for _ in range(consumed // self.batch):
                if self._lib.flashmoe_loader_next(self._handle,
                                                  scratch.ctypes.data):
                    raise RuntimeError(
                        f"native loader ended while fast-forwarding to "
                        f"row {consumed} of {self.path}")
                self._native_rows += self.batch
            return
        self._epoch, self._cursor = epoch, cursor
        self._order = (_xorshift_order(n, self.seed, epoch) if self.shuffle
                       else np.arange(n, dtype=np.int64))

    def close(self):
        """Release the native handle and the staging buffers; idempotent.
        A closed loader refuses iteration with a RuntimeError."""
        if self._handle is not None:
            self._lib.flashmoe_loader_close(self._handle)
            self._handle = None
        for slot in self._staging:
            if slot[1] is not None:
                slot[1].synchronize()
        self._staging = []
        self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
