"""PubSub topic names (a copy of retina_tpu/common/topics.py)."""

TOPIC_ENDPOINTS = "endpoints"  # veth/endpoint watcher events
TOPIC_APISERVER = "apiserver"  # apiserver IP set changes
TOPIC_PODS = "pods"  # pod identity add/update/delete
TOPIC_SERVICES = "services"
TOPIC_NODES = "nodes"
TOPIC_NAMESPACES = "namespaces"  # annotated-namespace set changes
TOPIC_SNAPSHOT = "snapshot"  # sketch-state snapshot announcements
