"""Runtime helpers (port of part of retina_tpu/utils/): the device proxy,
the metric names and the build metadata."""
