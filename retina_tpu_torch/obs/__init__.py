"""Pipeline observability (port of retina_tpu/obs/): the flight recorder
and the debug trace/profile API.

The flight recorder (`recorder.py`) is the always-on, bounded-overhead
span store every pipeline stage reports into; `debug.py` serves it
(``GET /debug/trace``) and owns the on-demand deep-profiling endpoint
(``POST /debug/profile``, a ``torch.profiler`` session).
"""

from retina_tpu_torch.obs.recorder import (
    FlightRecorder,
    get_recorder,
    initialize_recorder,
)

__all__ = [
    "FlightRecorder",
    "get_recorder",
    "initialize_recorder",
]
