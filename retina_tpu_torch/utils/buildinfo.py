"""Build metadata (a copy of retina_tpu/utils/buildinfo.py)."""

VERSION = "0.1.0"
APP_NAME = "retina-tpu"
USER_AGENT = f"{APP_NAME}/{VERSION}"
