"""Plugin surfaces (port of part of retina_tpu/plugins/): the engine's
bounded record sink (``api.py``)."""
