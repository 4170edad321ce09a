"""Debug endpoints over the flight recorder (port of retina_tpu/obs/debug.py).

- ``GET /debug/trace?last=N`` — dump the recorder's retained spans as
  Chrome trace-event JSON (load the body straight into Perfetto or
  chrome://tracing).
- ``POST /debug/profile?seconds=S`` — on-demand deep profiling: one
  single-flight ``torch.profiler`` session (CPU ops of every thread, and
  CUDA when the agent's engine runs on a card: the hand kernels by name),
  exported as Chrome trace JSON, plus an all-thread
  Python stack dump, written to a bounded artifact directory. Safe under
  load the same way the time-travel query service is: a session already in
  flight answers 503 busy, a cooldown bounds back-to-back sessions, and
  overload SHEDDING (and above) refuses new sessions outright — deep
  profiling is the first diagnostic to shed.

torch allows one profiler session in a process. A session that cannot
start because another is live (a caller's own ``torch.profiler.profile``)
answers 503 busy, as one of this object's own in flight does; any other
profiler failure leaves ``torch_trace`` false and still writes the stack
dump. The reply's ``torch_trace`` is the reference's ``jax_trace``.

Both ride the agent HTTP server (``server.py``); ``attach()`` registers
the routes.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import threading
import time
import traceback
from typing import Any

from retina_tpu_torch.log import logger
from retina_tpu_torch.obs.recorder import FlightRecorder, get_recorder
from retina_tpu_torch.runtime.overload import SHEDDING

_JSON = "application/json"
TRACE_FILE = "torch_trace.json"  # the session's export in its artifact dir


class ProfilerBusy(RuntimeError):
    """Another torch.profiler session is live in this process."""


def _reply(code: int, doc: dict) -> tuple[int, bytes, str]:
    return code, json.dumps(doc, default=str).encode(), _JSON


def thread_stacks() -> dict[str, list[str]]:
    """Formatted stacks of every live Python thread."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: dict[str, list[str]] = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, f"tid-{ident}")
        out[name] = traceback.format_stack(frame)
    return out


# Serializes the start of every session this module opens, so two agents in
# one process cannot both pass the liveness check below.
_start_lock = threading.Lock()


def _profiler_live() -> bool:
    """Whether a torch.profiler session is live in this process (a second
    one started from another thread takes the process down)."""
    import torch

    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False))


def _torch_session(outdir: str, seconds: float, cuda: bool) -> dict[str, float]:
    """One torch.profiler session of ``seconds`` wall, exported as Chrome
    trace JSON into ``outdir`` (TRACE_FILE). Returns its ``time.monotonic``
    marks: "start" (the call), "traced" (the tracer on), "stopped" (the
    tracer asked to stop) and "exported" (the file written)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marks = {"start": time.monotonic()}
    acts = [ProfilerActivity.CPU]
    if cuda and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    kw = {}
    try:
        # The agent's torch ops run on its lanes' threads, not on the
        # handler's: record every thread where this torch can.
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    prof = profile(activities=acts, **kw)
    with _start_lock:
        if _profiler_live():
            raise ProfilerBusy("another torch.profiler session is live")
        prof.__enter__()
    marks["traced"] = time.monotonic()
    try:
        time.sleep(seconds)
    finally:
        marks["stopped"] = time.monotonic()
        prof.__exit__(None, None, None)
    path = os.path.join(outdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    marks["exported"] = time.monotonic()
    logger("obs.debug").info(
        "profile session: started in %.2f s, %.1f s traced, stopped and exported in %.2f s "
        "(%d bytes)", marks["traced"] - marks["start"], seconds,
        marks["exported"] - marks["stopped"], os.path.getsize(path))
    return marks


class DebugObservability:
    """One per daemon/bench process; owns the profile artifact dir."""

    def __init__(
        self,
        cfg,
        recorder: FlightRecorder | None = None,
        overload=None,  # OverloadController (state read only)
    ) -> None:
        self.cfg = cfg
        self.log = logger("obs.debug")
        self.recorder = recorder or get_recorder()
        self._overload = overload
        # The profiler traces the card when the agent's engine runs on one
        # (device_platform "" is the card, "cpu" the plain versions).
        self.cuda = getattr(cfg, "device_platform", "") != "cpu"
        self._flight = threading.Lock()
        self._last_done = 0.0  # monotonic end of the last session
        self.sessions = 0
        self.last_marks: dict[str, float] = {}  # the last session's _torch_session marks

    # -- wiring --------------------------------------------------------
    def attach(self, server) -> None:
        server.register_route("/debug/trace", self.handle_trace)
        server.register_post_route("/debug/profile", self.handle_profile)
        server.expose_var("obs", self.recorder.stats)

    # -- GET /debug/trace (handler threads) ----------------------------
    def handle_trace(self, q: dict) -> tuple[int, bytes, str]:
        try:
            last = None
            if "last" in q:
                last = max(0, int(q["last"][0]))
        except (ValueError, IndexError):
            return _reply(400, {"error": "last must be an integer"})
        doc = self.recorder.chrome_trace(last)
        return 200, json.dumps(doc).encode(), _JSON

    # -- POST /debug/profile (handler threads; single-flight) ----------
    def handle_profile(self, q: dict) -> tuple[int, bytes, str]:
        try:
            seconds = float(q.get("seconds", ["2"])[0])
        except (ValueError, IndexError):
            return _reply(400, {"error": "seconds must be a number"})
        seconds = min(max(seconds, 0.1), float(self.cfg.profile_max_seconds))
        ov = self._overload
        if ov is not None and ov.state >= SHEDDING:
            # The agent is already shedding enrichment work to protect the
            # datapath; a profiler session would add host load at the
            # worst moment.
            return _reply(503, {"error": "shedding", "retry": True})
        cooldown = float(self.cfg.profile_cooldown_s)
        since = time.monotonic() - self._last_done
        if self._last_done and since < cooldown:
            return _reply(503, {
                "error": "cooldown",
                "retry_after_s": round(cooldown - since, 1),
            })
        if not self._flight.acquire(blocking=False):
            return _reply(503, {"error": "busy", "retry": True})
        try:
            doc = self._run_session(seconds)
            return _reply(200, doc)
        except ProfilerBusy:
            return _reply(503, {"error": "busy", "retry": True})
        except Exception as e:
            self.log.exception("profile session failed")
            return _reply(500, {"error": f"{type(e).__name__}: {e}"})
        finally:
            self._last_done = time.monotonic()
            self._flight.release()

    def _run_session(self, seconds: float) -> dict[str, Any]:
        outdir = os.path.join(
            self.cfg.profile_artifact_dir,
            f"profile-{int(time.time())}-{os.getpid()}",
        )
        os.makedirs(outdir, exist_ok=True)
        torch_ok = True
        try:
            self.last_marks = _torch_session(outdir, seconds, self.cuda)
        except ProfilerBusy:
            with contextlib.suppress(OSError):
                os.rmdir(outdir)  # only if this session left it empty
            raise
        except Exception as e:
            # The stack dump below still lands: a host-side hang is
            # diagnosable even when the device profiler is unavailable.
            torch_ok = False
            self.log.warning("torch.profiler session failed: %s: %s",
                             type(e).__name__, e)
        stacks = thread_stacks()
        with open(os.path.join(outdir, "threads.txt"), "w") as fh:
            for name, frames in sorted(stacks.items()):
                fh.write(f"=== {name} ===\n")
                fh.writelines(frames)
                fh.write("\n")
        self._prune_artifacts()
        self.sessions += 1
        return {
            "artifact_dir": outdir,
            "seconds": seconds,
            "torch_trace": torch_ok,
            "threads": sorted(stacks),
        }

    def _prune_artifacts(self) -> None:
        """Bound the artifact dir: keep the newest ``profile_max_artifacts``
        session dirs, delete the rest."""
        root = self.cfg.profile_artifact_dir
        keep = max(1, int(self.cfg.profile_max_artifacts))
        try:
            entries = sorted(
                e for e in os.listdir(root) if e.startswith("profile-")
            )
        except OSError:
            return
        for stale in entries[:-keep]:
            shutil.rmtree(os.path.join(root, stale), ignore_errors=True)
