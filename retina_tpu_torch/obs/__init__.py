"""Pipeline observability (port of retina_tpu/obs/): the flight recorder
(`recorder.py`), the always-on, bounded-overhead span store every pipeline
stage reports into. The reference's debug surface (`debug.py`:
``GET /debug/trace``, ``POST /debug/profile``) is not ported yet.
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
