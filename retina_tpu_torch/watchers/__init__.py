"""Host watchers (port of retina_tpu/watchers/, reference pkg/watchers):
endpoint + apiserver."""
