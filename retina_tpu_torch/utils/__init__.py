"""Runtime helpers (port of part of retina_tpu/utils/): the device proxy."""
