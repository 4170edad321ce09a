"""Operator: cluster-scoped reconcilers and the cluster plumbing the agent
shares with them (port of retina_tpu/operator/; reference operator/ +
pkg/controllers/operator).

The ``Operator`` (``operator.py``) runs Captures through the capture
paths and reconciles the module CRs and RetinaEndpoints; the kube client,
the core/v1 and CiliumEndpoint watchers, the CRD store and its bridges,
the CRD self-install and the leader election are its plumbing.
"""

from retina_tpu_torch.operator.store import CRDStore
from retina_tpu_torch.operator.operator import Operator

__all__ = ["CRDStore", "Operator"]
