"""Operator: cluster-scoped reconcilers and the cluster plumbing the agent
shares with them (port of retina_tpu/operator/ but for ``operator.py``).

The kube client, the core/v1 and CiliumEndpoint watchers, the CRD store
and its bridges, the CRD self-install and the leader election are here.
The reference's ``Operator`` (``operator.py``, which runs Captures through
the capture paths) comes with the capture paths in the next slice
(ROADMAP §1 item 7).
"""

from retina_tpu_torch.operator.store import CRDStore

__all__ = ["CRDStore"]
