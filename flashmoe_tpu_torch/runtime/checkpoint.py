"""Checkpoints of a :class:`TrainState`, with integrity manifests.

Counterpart of ``flashmoe_tpu/runtime/checkpoint.py:49-596``, with
torch-native storage in place of orbax.  A step lives in ``<dir>/<step>/``:
one raw file a leaf of the state (params, the optimizer's count and
moments, step, and the guard when there is one), flattened by key path,
and ``tree.json``, which names each leaf's key path, dtype, shape and
file.  A leaf's bytes are the tensor's own, so :func:`restore` puts back
the saved bits on the template's device.

Durability, as in JAX: a step is written into a private directory, each
file ``fsync``'d, and the directory renamed to ``<dir>/<step>``; only then
is ``manifest-<step>.json`` written (size and CRC32 per payload file, and
the ``loader``, ``controller`` and ``quant`` blocks where given, JAX's
keys).  A kill mid-payload leaves a private directory no query sees; a
kill between payload and manifest leaves a manifest-less step, which
:func:`verify` accepts as JAX does.  :func:`restore` verifies first and,
on corruption, falls back to the newest intact older step (a
``checkpoint.fallback`` decision).  ``MAX_TO_KEEP`` steps are kept.

``save(..., blocking=False)`` copies the state to pinned host memory
(each leaf ``non_blocking``, then one event waited on, so the copy has
finished when ``save`` returns and the loop pays only that) and hands the
write to one background thread with a depth-1 newest-wins queue per
directory.  :func:`wait_for_saves` drains it.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from flashmoe_tpu_torch.config import dtype_name
from flashmoe_tpu_torch.runtime.trainer import TrainState, init_guard_state
from flashmoe_tpu_torch.tree import tree_leaves, tree_map, \
    tree_map_with_path
from flashmoe_tpu_torch.utils.integrity import crc32_file
from flashmoe_tpu_torch.utils.telemetry import metrics as _telemetry


class CheckpointCorruptionError(RuntimeError):
    """No intact checkpoint could be restored from the directory."""


# retained checkpoints per directory
MAX_TO_KEEP = 3
TREE_FILE = "tree.json"
_TMP_PREFIX = ".tmp-"

# one lock per directory: the async writer and the step loop both write
# and prune it (JAX's per-directory orbax manager)
_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def _dir_lock(directory: str) -> threading.Lock:
    key = os.path.abspath(directory)
    with _LOCKS_LOCK:
        lock = _LOCKS.get(key)
        if lock is None:
            lock = _LOCKS[key] = threading.Lock()
    return lock


def close_manager(directory: str) -> None:
    """Drop the directory's cached lock (JAX closes its orbax manager)."""
    with _LOCKS_LOCK:
        _LOCKS.pop(os.path.abspath(directory), None)


def close_all_managers() -> None:
    for key in list(_LOCKS):
        close_manager(key)


# ----------------------------------------------------------------------
# The payload: a state's leaves by key path
# ----------------------------------------------------------------------

def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _flatten(state) -> list[tuple[str, torch.Tensor]]:
    """(key path, tensor) for every leaf of the state; a state without a
    guard has no guard entry (JAX's ``_payload``, :85-94)."""
    d = state._asdict()
    if d.get("guard") is None:
        d.pop("guard", None)
    out = []
    tree_map_with_path(lambda p, t: out.append((_key(p), t)), d)
    return out


def _host_snapshot(state) -> list[tuple[str, torch.Tensor]]:
    """A copy of the state's leaves on the host: for a state on the card
    in pinned memory, each copy ``non_blocking``, then one event waited
    on, so that every copy has landed when this returns."""
    flat = _flatten(state)
    if not any(t.is_cuda for _, t in flat):
        return [(k, t.detach().to("cpu", copy=True)) for k, t in flat]
    out = []
    for k, t in flat:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t.detach(), non_blocking=True)
        out.append((k, h))
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return out


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_payload(directory: str, flat, step: int) -> str:
    """Write the leaves (each copied to the host just before its write)
    into a private directory, ``fsync`` each file, and rename it to the
    step directory (replacing an older copy of the step).  Returns the
    step directory."""
    root = os.path.abspath(directory)
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f"{_TMP_PREFIX}{step}-{os.getpid()}-"
                             f"{threading.get_ident()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    entries = []
    for i, (key, t) in enumerate(flat):
        name = f"{i:05d}.bin"
        raw = t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy()
        with open(os.path.join(tmp, name), "wb") as f:
            f.write(memoryview(raw))
            f.flush()
            os.fsync(f.fileno())
        entries.append({"key": key, "dtype": dtype_name(t.dtype),
                        "shape": list(t.shape), "file": name})
    with open(os.path.join(tmp, TREE_FILE), "w") as f:
        json.dump({"leaves": entries}, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    dst = step_dir(directory, step)
    if os.path.exists(dst):
        # re-saving a step (after a rewind): its old manifest goes first,
        # so no manifest ever describes the other copy's bytes
        try:
            os.remove(_manifest_path(directory, step))
        except FileNotFoundError:
            pass
        shutil.rmtree(dst)
    os.rename(tmp, dst)
    _fsync_dir(root)
    return dst


def _read_tree(directory: str, step: int) -> dict | None:
    try:
        with open(os.path.join(step_dir(directory, step), TREE_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ----------------------------------------------------------------------
# Integrity manifests
# ----------------------------------------------------------------------

def step_dir(directory: str, step: int) -> str:
    """The directory holding one checkpoint's payload."""
    return os.path.join(os.path.abspath(directory), str(step))


def _manifest_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"manifest-{step}.json")


def _walk_payload(root: str) -> dict[str, dict]:
    out: dict[str, dict] = {}
    for base, _dirs, files in os.walk(root):
        for name in files:
            p = os.path.join(base, name)
            out[os.path.relpath(p, root)] = {"size": os.path.getsize(p),
                                             "crc32": crc32_file(p)}
    return out


def write_manifest(directory: str, step: int,
                   loader_state: dict | None = None,
                   controller_state: dict | None = None,
                   quant_meta: dict | None = None) -> str:
    """Checksum every file of the step directory into
    ``manifest-<step>.json`` (JAX's keys: ``step``, ``files``, and
    ``loader``, ``controller``, ``quant`` where given); returns its path.
    Written through a private name and an atomic rename, so no reader
    sees a torn manifest."""
    manifest: dict[str, Any] = {
        "step": step, "files": _walk_payload(step_dir(directory, step))}
    if loader_state is not None:
        manifest["loader"] = dict(loader_state)
    if controller_state is not None:
        manifest["controller"] = dict(controller_state)
    if quant_meta is not None:
        manifest["quant"] = dict(quant_meta)
    path = _manifest_path(directory, step)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def verify(directory: str, step: int) -> bool:
    """Recompute the step's checksums against its manifest: False on a
    missing, resized or changed file or an unreadable manifest.  A step
    without a manifest verifies True (no integrity claim to check)."""
    root = step_dir(directory, step)
    if not os.path.isdir(root):
        return False
    mpath = _manifest_path(directory, step)
    if not os.path.exists(mpath):
        return True
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    want = manifest.get("files", {})
    have = _walk_payload(root)
    if set(want) != set(have):
        return False
    return all(have[rel] == meta for rel, meta in want.items())


def _manifest_block(directory: str, step: int, key: str):
    try:
        with open(_manifest_path(directory, step)) as f:
            return json.load(f).get(key)
    except (OSError, ValueError):
        return None


def load_loader_state(directory: str, step: int) -> dict | None:
    """The data-loader cursor stored in the step's manifest, or None."""
    loader = _manifest_block(directory, step, "loader")
    return dict(loader) if isinstance(loader, dict) else None


def load_quant_metadata(directory: str, step: int) -> dict | None:
    """The quantized-storage block of the step's manifest, CRC-verified,
    or None; :class:`CheckpointCorruptionError` when a block fails its
    content CRC."""
    from flashmoe_tpu_torch.quant import verify_quant_metadata

    block = _manifest_block(directory, step, "quant")
    if block is None:
        return None
    if not isinstance(block, dict) or not verify_quant_metadata(block):
        raise CheckpointCorruptionError(
            f"checkpoint step {step} in {directory} carries a quant "
            f"metadata block that fails its content CRC")
    return dict(block)


def _state_quant_meta(state) -> dict | None:
    """The manifest's quant block from a state's params (None at full
    precision); never fails a save."""
    params = getattr(state, "params", None)
    if params is None:
        return None
    try:
        from flashmoe_tpu_torch.quant import quant_metadata

        return quant_metadata(params)
    except Exception:  # noqa: BLE001 - metadata must never fail a save
        return None


def load_controller_state(directory: str, step: int) -> dict | None:
    """The runtime controller's plan stored in the step's manifest, or
    None (read from the manifest only)."""
    cs = _manifest_block(directory, step, "controller")
    return dict(cs) if isinstance(cs, dict) else None


def restore_loader_state(directory: str, step: int, loader) -> bool:
    """Reposition ``loader`` from the step's manifest cursor; False when
    the loader is stateless or None or the manifest has no cursor."""
    if loader is None or not hasattr(loader, "load_state_dict"):
        return False
    ls = load_loader_state(directory, step)
    if ls is None:
        return False
    loader.load_state_dict(ls)
    return True


def has_guard(directory: str, step: int) -> bool | None:
    """Whether the step's payload holds a ``guard`` subtree; None when its
    tree file cannot be read."""
    tree = _read_tree(directory, step)
    if tree is None:
        return None
    return any(e["key"].split("/")[0] == "guard" for e in tree["leaves"])


def all_steps(directory: str) -> list[int]:
    """Every committed step of the directory, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isdir(os.path.join(directory,
                                                                n)))


def _prune(directory: str) -> None:
    """Keep the newest ``MAX_TO_KEEP`` steps; drop older steps and every
    manifest whose step is gone."""
    steps = all_steps(directory)
    for s in steps[:-MAX_TO_KEEP]:
        try:
            os.remove(_manifest_path(directory, s))
        except FileNotFoundError:
            pass
        shutil.rmtree(step_dir(directory, s), ignore_errors=True)
    keep = {str(s) for s in steps[-MAX_TO_KEEP:]}
    for path in glob.glob(os.path.join(os.path.abspath(directory),
                                       "manifest-*.json")):
        if os.path.basename(path)[len("manifest-"):-len(".json")] \
                not in keep:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass


# ----------------------------------------------------------------------
# Async writer: one background thread, depth-1 newest-wins queue
# ----------------------------------------------------------------------

class _AsyncWriter:
    """Serializes async checkpoint jobs off the step loop.

    Depth 1 per directory, newest wins: a queued snapshot not yet started
    is replaced by a newer one for the same directory; jobs of other
    directories queue side by side, and the job in flight always
    completes.  Errors are collected, recorded as
    ``checkpoint.async_error`` decisions and returned by
    :func:`wait_for_saves`."""

    def __init__(self):
        self._cond = threading.Condition()
        # abspath -> job; dict order is FIFO across directories, and a
        # replacement keeps the original slot
        self._pending: dict[str, tuple] = {}
        self._in_flight = False
        self._thread: threading.Thread | None = None
        self._errors: list[Exception] = []
        self.dropped = 0
        self.completed = 0

    def submit(self, job: tuple) -> None:
        with self._cond:
            key = os.path.abspath(job[0])
            if key in self._pending:
                self.dropped += 1
            self._pending[key] = job
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="flashmoe-ckpt-writer",
                    daemon=True)
                self._thread.start()
            self._cond.notify_all()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending:
                    self._cond.wait()
                job = self._pending.pop(next(iter(self._pending)))
                self._in_flight = True
            directory, host_state, step, loader_state, ctrl_state = job
            try:
                _write_sync(directory, host_state, step, loader_state,
                            ctrl_state)
                with self._cond:
                    self.completed += 1
            except Exception as e:  # noqa: BLE001 - surfaced by wait()
                with self._cond:
                    self._errors.append(e)
                _telemetry.decision(
                    "checkpoint.async_error",
                    directory=os.path.abspath(directory), step=step,
                    error=f"{type(e).__name__}: {str(e)[:200]}")
            finally:
                with self._cond:
                    self._in_flight = False
                    self._cond.notify_all()

    def wait(self, timeout: float | None = None) -> list[Exception]:
        """Block until nothing is queued or in flight; return (and clear)
        the errors collected since the last call."""
        with self._cond:
            self._cond.wait_for(
                lambda: not self._pending and not self._in_flight,
                timeout=timeout)
            errors, self._errors = self._errors, []
            return errors


_WRITER = _AsyncWriter()


def wait_for_saves(timeout: float | None = None) -> list[Exception]:
    """Barrier for async saves: block until the writer is idle; returns
    the errors it hit since the last barrier."""
    return _WRITER.wait(timeout)


def async_save_stats() -> dict:
    """The writer's counters: completed, dropped (newest-wins
    replacements)."""
    return {"completed": _WRITER.completed, "dropped": _WRITER.dropped}


# ----------------------------------------------------------------------
# Save / restore
# ----------------------------------------------------------------------

class _HostState:
    """A state copied to pinned host memory: its flat leaves and its quant
    block (what :func:`_write_sync` needs of a :class:`TrainState`)."""

    def __init__(self, state):
        self.flat = _host_snapshot(state)
        self.quant_meta = _state_quant_meta(state)


def _write_sync(directory: str, state, step: int,
                loader_state: dict | None,
                controller_state: dict | None = None) -> None:
    """The durable write: the payload (committed by a rename), then the
    manifest, then the retention prune.  ``state``: a
    :class:`TrainState` (its leaves go to the host one at a time) or a
    host snapshot of one."""
    if isinstance(state, _HostState):
        flat, quant_meta = state.flat, state.quant_meta
    else:
        flat, quant_meta = _flatten(state), _state_quant_meta(state)
    with _dir_lock(directory):
        _write_payload(directory, flat, step)
        write_manifest(directory, step, loader_state=loader_state,
                       controller_state=controller_state,
                       quant_meta=quant_meta)
        _prune(directory)


def save(directory: str, state: TrainState, step: int | None = None, *,
         blocking: bool = True,
         loader_state: dict | None = None,
         controller_state: dict | None = None) -> int:
    """Save a checkpoint; returns its step.

    ``blocking=False`` copies the state to pinned host memory (the only
    cost left on the step loop) and hands the write to the background
    writer; call :func:`wait_for_saves` before reading it back or exiting.
    ``loader_state``: the data-loader cursor for the manifest;
    ``controller_state``: the runtime controller's plan."""
    step = int(state.step) if step is None else step
    if not blocking:
        _WRITER.submit((directory, _HostState(state), step,
                        loader_state, controller_state))
        return step
    _write_sync(directory, state, step, loader_state, controller_state)
    return step


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def intact_steps(directory: str) -> list[int]:
    """All steps whose payload verifies, newest last."""
    return [s for s in all_steps(directory) if verify(directory, s)]


def _load_leaf(root: str, entry: dict, device) -> torch.Tensor:
    dt = getattr(torch, entry["dtype"])
    raw = np.fromfile(os.path.join(root, entry["file"]), dtype=np.uint8)
    t = torch.from_numpy(raw).view(dt).reshape(entry["shape"])
    return t.to(device)


def _read_state(directory: str, step: int, template: TrainState,
                device=None) -> TrainState:
    """The step's payload in the template's structure, each leaf on the
    template leaf's device (``device`` for a template on ``meta``)."""
    tree = _read_tree(directory, step)
    if tree is None:
        raise CheckpointCorruptionError(
            f"checkpoint step {step} in {directory} has no readable "
            f"{TREE_FILE}")
    saved = {e["key"]: e for e in tree["leaves"]}
    want = dict(_flatten(template))
    extra = sorted(set(saved) - set(want))
    if extra:
        raise ValueError(
            f"checkpoint step {step} in {directory} holds leaves the "
            f"restore template lacks: {extra[:4]}")
    missing = sorted(set(want) - set(saved))
    fresh_guard = template.guard is not None and all(
        k.startswith("guard/") for k in missing) and missing
    if missing and not fresh_guard:
        raise ValueError(
            f"checkpoint step {step} in {directory} lacks leaves of the "
            f"restore template: {missing[:4]}")
    root = step_dir(directory, step)

    def leaf(path, t):
        key = _key(path)
        dev = device if device is not None else t.device
        if dev is None or torch.device(dev).type == "meta":
            raise ValueError(
                "restore into a template on 'meta' needs device=")
        e = saved[key]
        if e["dtype"] != dtype_name(t.dtype) or e["shape"] != list(t.shape):
            raise ValueError(
                f"checkpoint leaf {key}: {e['dtype']} {e['shape']} on "
                f"disk, {dtype_name(t.dtype)} {list(t.shape)} in the "
                f"template")
        return _load_leaf(root, e, dev)

    d = template._asdict()
    guard = d.pop("guard", None)
    out = tree_map_with_path(leaf, d)
    if guard is not None:
        if fresh_guard:
            # a guarded template over a guard-free checkpoint: a fresh
            # GuardState, its EMA warms again (JAX's _fresh_guard)
            dev = device if device is not None else \
                tree_leaves(guard)[0].device
            out["guard"] = init_guard_state(dev)
        else:
            out["guard"] = tree_map_with_path(
                lambda p, t: leaf(("guard",) + p, t), guard)
    return TrainState(**out)


def restore(directory: str, template: TrainState,
            step: int | None = None, *, check_integrity: bool = True,
            fallback: bool = True, device=None) -> TrainState:
    """Restore into the template's structure, each leaf on the template
    leaf's device, bit for bit.  A template built on ``meta`` (shapes and
    dtypes, no storage) needs ``device``.

    With ``check_integrity`` the step is verified first; on corruption,
    ``fallback`` takes the newest older intact step (a
    ``checkpoint.fallback`` decision), and
    :class:`CheckpointCorruptionError` is raised only when none is left."""
    want = step if step is not None else latest_step(directory)
    if want is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    chosen = want
    if check_integrity and not verify(directory, want):
        older = [s for s in all_steps(directory)
                 if s < want and verify(directory, s)]
        if not fallback or not older:
            raise CheckpointCorruptionError(
                f"checkpoint step {want} in {directory} failed integrity "
                f"verification and no intact older step exists")
        chosen = older[-1]
        _telemetry.decision(
            "checkpoint.fallback", directory=os.path.abspath(directory),
            corrupt_step=want, restored_step=chosen,
            lost_steps=want - chosen)
    return _read_state(directory, chosen, template, device)


def emergency_save(directory: str, state: TrainState,
                   loader_state: dict | None = None,
                   controller_state: dict | None = None) -> int | None:
    """Best-effort save for abort paths: persists ``state`` unless its
    step is already on disk; never raises (the caller is already failing).
    Returns the saved step, or None."""
    try:
        if state is None:
            return None
        wait_for_saves()
        step = int(state.step)
        if latest_step(directory) == step:
            return None
        saved = save(directory, state, step=step, loader_state=loader_state,
                     controller_state=controller_state)
        _telemetry.decision("checkpoint.emergency_save",
                            directory=os.path.abspath(directory), step=saved)
        return saved
    except Exception:  # noqa: BLE001 - abort path, never re-raise
        return None


def abstract_state(state: TrainState) -> TrainState:
    """The state's shapes and dtypes on ``meta`` (no storage): a restore
    template that allocates no second copy (JAX's ``ShapeDtypeStruct``
    tree)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), state)
