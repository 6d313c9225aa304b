"""Crash postmortem bundles: what a triage needs, in one directory.

Counterpart of ``flashmoe_tpu/profiler/postmortem.py``.  When in-job
recovery gives up (``resilient_train`` spends its retries, ``supervise``
its restarts), the state that explains the failure is frozen to disk as
small self-describing files, with the same names and manifest keys as
JAX's::

    bundle-<stamp>/
      MANIFEST.json     bundle version, error summary, file inventory
      traceback.txt     the formatted exception chain
      decisions.jsonl   run + global decision streams (tagged)
      metrics.json      counters/gauges/timer summary
      flight.jsonl      flight-ring records (or the history list)
      config.json       the resolved MoEConfig (when known)
      planner.json      last path selection + fresh predictions
      env.json          python, torch and CUDA versions, the device, env
      trace.json        profiler timeline (when one was armed)

Writing is best-effort: a postmortem writer never masks the failure it
documents, so every section is guarded and a partial bundle is still a
bundle.  :func:`load_bundle` reads one back.
"""

from __future__ import annotations

import json
import os
import time
import traceback

BUNDLE_VERSION = 1
MANIFEST = "MANIFEST.json"

_SEQ = [0]  # same-process uniqueness for same-second bundles


def _bundle_name(step) -> str:
    _SEQ[0] += 1
    stamp = time.strftime("%Y%m%d-%H%M%S")
    tag = f"step{int(step)}" if step is not None else "nostep"
    return f"bundle-{stamp}-{tag}-p{os.getpid()}-{_SEQ[0]}"


def write_bundle(directory: str, *, error=None, cfg=None,
                 metrics_obj=None, history=None, recorder=None,
                 timeline=None, step=None, extra: dict | None = None
                 ) -> str | None:
    """Write one bundle under ``directory``; returns its path, or None
    when even the directory could not be created (best-effort all the
    way down — the caller is already on a failure path)."""
    try:
        os.makedirs(directory, exist_ok=True)
        bundle = os.path.join(directory, _bundle_name(step))
        os.makedirs(bundle)
    except OSError:
        return None

    files: list[str] = []

    def _write(name: str, writer) -> None:
        try:
            writer(os.path.join(bundle, name))
            files.append(name)
        except Exception:  # noqa: BLE001 — never mask the crash
            pass

    # the decision goes into the GLOBAL stream first so the bundle's
    # own decisions.jsonl carries the record of its creation
    from flashmoe_tpu_torch.utils.telemetry import metrics as global_metrics

    try:
        sink = metrics_obj if metrics_obj is not None else global_metrics
        sink.decision("postmortem.saved", dir=bundle,
                      step=(int(step) if step is not None else None),
                      error=(f"{type(error).__name__}: {error}"[:300]
                             if error is not None else None))
    except Exception:  # noqa: BLE001
        pass

    if error is not None:
        def _tb(path):
            with open(path, "w") as f:
                if getattr(error, "__traceback__", None) is not None:
                    f.write("".join(traceback.format_exception(
                        type(error), error, error.__traceback__)))
                else:
                    f.write(f"{type(error).__name__}: {error}\n")
        _write("traceback.txt", _tb)

    def _decisions(path):
        with open(path, "w") as f:
            if metrics_obj is not None:
                for d in metrics_obj.decisions:
                    f.write(json.dumps(dict(d, stream="run")) + "\n")
            for d in global_metrics.decisions:
                f.write(json.dumps(dict(d, stream="global")) + "\n")
    _write("decisions.jsonl", _decisions)

    if metrics_obj is not None:
        _write("metrics.json", lambda p: json.dump(
            metrics_obj.summary(), open(p, "w"), default=str))

    flight = (recorder.records if recorder is not None
              else list(history or []))
    if flight:
        def _flight(path):
            with open(path, "w") as f:
                for rec in flight:
                    f.write(json.dumps(rec, default=str) + "\n")
        _write("flight.jsonl", _flight)

    if cfg is not None:
        _write("config.json", lambda p: open(p, "w").write(
            cfg.to_json()))

        def _planner(path):
            from flashmoe_tpu_torch import tuning
            from flashmoe_tpu_torch.planner.model import predict_paths

            sel = None
            for src in ([metrics_obj] if metrics_obj is not None
                        else []) + [global_metrics]:
                sel = sel or src.last_decision("planner.path_select")
            doc = {"last_path_select": sel}
            try:
                preds = predict_paths(cfg, max(cfg.ep, 1),
                                      tuning.generation())
                doc["predictions"] = [{
                    "path": p.path, "feasible": p.feasible,
                    "total_ms": round(p.total_ms, 4), "note": p.note,
                } for p in preds]
            except Exception as e:  # noqa: BLE001 — partial is fine
                doc["prediction_error"] = f"{type(e).__name__}: {e}"
            json.dump(doc, open(path, "w"))
        _write("planner.json", _planner)

    def _env(path):
        import platform
        import sys

        import torch

        doc = {
            "python": sys.version,
            "platform": platform.platform(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "env": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith(("FLASHMOE_", "CUDA_", "TORCH_"))},
        }
        try:
            doc["backend"] = ("cuda" if torch.cuda.is_available()
                              else "cpu")
            doc["device_count"] = torch.cuda.device_count()
            if torch.cuda.is_available():
                doc["device_name"] = torch.cuda.get_device_name(0)
        except Exception as e:  # noqa: BLE001 — backend may be wedged
            doc["backend_error"] = f"{type(e).__name__}: {e}"
        json.dump(doc, open(path, "w"))
    _write("env.json", _env)

    if timeline is None:
        from flashmoe_tpu_torch.profiler import spans

        timeline = spans.active()
    if timeline is not None and (timeline.spans or timeline.sections):
        def _trace(path):
            from flashmoe_tpu_torch.profiler.export import write_trace

            write_trace(timeline, path)
        _write("trace.json", _trace)

    manifest = {
        "bundle_version": BUNDLE_VERSION,
        "created_unix": time.time(),
        "step": int(step) if step is not None else None,
        "error": (f"{type(error).__name__}: {error}"[:500]
                  if error is not None else None),
        "files": sorted(files),
    }
    if extra:
        manifest["extra"] = extra
    try:
        with open(os.path.join(bundle, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2, default=str)
    except OSError:
        return None
    return bundle


def is_bundle(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MANIFEST))


def find_bundles(directory: str) -> list[str]:
    """Bundle dirs under ``directory`` (itself included if it IS one),
    oldest first."""
    if not os.path.isdir(directory):
        return []
    if is_bundle(directory):
        return [directory]
    out = [os.path.join(directory, n)
           for n in sorted(os.listdir(directory))
           if is_bundle(os.path.join(directory, n))]
    return out


def load_bundle(path: str) -> dict:
    """Parse a bundle back into memory (tolerant: missing files yield
    missing keys)."""
    if not is_bundle(path):
        raise FileNotFoundError(f"{path!r} is not a postmortem bundle "
                                f"(no {MANIFEST})")
    out: dict = {"path": path}
    with open(os.path.join(path, MANIFEST)) as f:
        out["manifest"] = json.load(f)

    def _maybe_json(name):
        p = os.path.join(path, name)
        if os.path.isfile(p):
            try:
                with open(p) as f:
                    return json.load(f)
            except ValueError:
                return None
        return None

    def _maybe_jsonl(name):
        p = os.path.join(path, name)
        recs = []
        if os.path.isfile(p):
            with open(p) as f:
                for line in f:
                    try:
                        recs.append(json.loads(line))
                    except ValueError:
                        continue
        return recs

    out["config"] = _maybe_json("config.json")
    out["env"] = _maybe_json("env.json")
    out["metrics"] = _maybe_json("metrics.json")
    out["planner"] = _maybe_json("planner.json")
    out["trace"] = _maybe_json("trace.json")
    out["decisions"] = _maybe_jsonl("decisions.jsonl")
    out["flight"] = _maybe_jsonl("flight.jsonl")
    tb = os.path.join(path, "traceback.txt")
    if os.path.isfile(tb):
        with open(tb) as f:
            out["traceback"] = f.read()
    return out
