"""Managers (port of part of retina_tpu/managers/): the filter manager."""
