"""API types (port of part of retina_tpu/crd/): MetricsConfiguration."""
