"""The agent's runtime (port of part of retina_tpu/runtime/): the overload
controller (``overload.py``), the supervision tree (``supervisor.py``) and
the fault-injection layer (``faults.py``)."""
