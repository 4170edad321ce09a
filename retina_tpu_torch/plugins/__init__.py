"""Plugin surfaces (port of part of retina_tpu/plugins/): the plugin base
and the engine's bounded record sink (``api.py``), the registry, the
conntrack GC plugin and the drop-reason names."""
