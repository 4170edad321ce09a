"""Identity cache (port of part of retina_tpu/controllers/): the pod cache."""
