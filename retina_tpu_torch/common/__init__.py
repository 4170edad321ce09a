"""Shared domain objects and pubsub topics (port of retina_tpu/common/).

Reference analog: pkg/common — RetinaEndpoint/RetinaSvc/RetinaNode identity
objects (endpoint.go), DirtyCache (dirtycache.go), pubsub topic constants
(pubsubtopics.go), apiretry.
"""

from retina_tpu_torch.common.objects import (
    POD_ANNOTATION,
    POD_ANNOTATION_VALUE,
    DirtyCache,
    IPFamily,
    RetinaEndpoint,
    RetinaNode,
    RetinaSvc,
    retry,
)
from retina_tpu_torch.common.topics import (
    TOPIC_APISERVER,
    TOPIC_ENDPOINTS,
    TOPIC_NAMESPACES,
    TOPIC_NODES,
    TOPIC_PODS,
    TOPIC_SERVICES,
    TOPIC_SNAPSHOT,
)

__all__ = [
    "DirtyCache",
    "IPFamily",
    "RetinaEndpoint",
    "RetinaNode",
    "RetinaSvc",
    "retry",
    "POD_ANNOTATION",
    "POD_ANNOTATION_VALUE",
    "TOPIC_APISERVER",
    "TOPIC_ENDPOINTS",
    "TOPIC_NAMESPACES",
    "TOPIC_NODES",
    "TOPIC_PODS",
    "TOPIC_SERVICES",
    "TOPIC_SNAPSHOT",
]
