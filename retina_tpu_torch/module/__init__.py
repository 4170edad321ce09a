"""Metrics module (port of part of retina_tpu/module/): metric objects and their publisher."""
