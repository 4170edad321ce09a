"""fleetquery: federated time-travel range queries over the fleet (port of
retina_tpu/fleetquery/).

The node tier (``timetravel/``) answers ``[t0, t1)`` range queries over one
process's snapshot rings. This package lifts the same contract to the
cluster: ``GET /fleet/query`` scatter-gathers per-node span folds (or folds
the aggregator's merged-epoch ring when this process is the aggregator),
merges them with the fleet rollup's fold on the card (K8, K9) and answers
cluster-wide top-k, cardinality and entropy with an explicit coverage
annotation when part of the fleet misses its deadline. ``dryrun.py`` is the
64-node query storm and the detector trio's closed loops.
"""

from retina_tpu_torch.fleetquery.service import FleetQueryService, LocalNodeClient

__all__ = ["FleetQueryService", "LocalNodeClient"]
