"""Basic metric declarations + control-plane self metrics (port of
retina_tpu/metrics.py; the same families, names, labels and buckets, in the
same order, so that the two agents' expositions match).

Reference analog: pkg/metrics/metrics.go:14-120 — ``InitializeMetrics``
creates every node-level gauge and control-plane counter once at daemon
start, into the default registry. Names come from utils.metric_names
(networkobservability_*). Advanced (pod-level) metric families are created
by the metrics module on reconcile instead (module/metrics.py).
"""

from __future__ import annotations

import threading
from typing import Optional

from retina_tpu_torch.exporter import Exporter, get_exporter
from retina_tpu_torch.log import logger
from retina_tpu_torch.utils import metric_names as mn

_log = logger("metrics")


class Metrics:
    """All basic gauges/counters, created against one Exporter."""

    def __init__(self, exporter: Optional[Exporter] = None) -> None:
        ex = exporter or get_exporter()
        g, c = ex.new_gauge, ex.new_counter
        # node-level data-plane gauges (metrics.go:14-80)
        self.drop_count = g(mn.DROP_COUNT, [mn.L_REASON, mn.L_DIRECTION])
        self.drop_bytes = g(mn.DROP_BYTES, [mn.L_REASON, mn.L_DIRECTION])
        self.forward_count = g(mn.FORWARD_COUNT, [mn.L_DIRECTION])
        self.forward_bytes = g(mn.FORWARD_BYTES, [mn.L_DIRECTION])
        self.tcp_state = g(mn.TCP_STATE, [mn.L_STATE])
        self.tcp_connection_remote = g(
            mn.TCP_CONNECTION_REMOTE, [mn.L_IP, mn.L_PORT]
        )
        self.tcp_connection_stats = g(mn.TCP_CONNECTION_STATS, [mn.L_STAT])
        self.tcp_flag_counters = g(mn.TCP_FLAG_COUNTERS, [mn.L_FLAG])
        self.ip_connection_stats = g(mn.IP_CONNECTION_STATS, [mn.L_STAT])
        self.udp_connection_stats = g(mn.UDP_CONNECTION_STATS, [mn.L_STAT])
        self.interface_stats = g(
            mn.INTERFACE_STATS, [mn.L_INTERFACE, mn.L_STAT]
        )
        self.infiniband_counter_stats = g(
            mn.INFINIBAND_COUNTER_STATS, ["device", "port", mn.L_STAT]
        )
        self.infiniband_status_params = g(
            mn.INFINIBAND_STATUS_PARAMS, ["interface", mn.L_STAT]
        )
        self.dns_request_count = g(mn.DNS_REQUEST_COUNT, [mn.L_QTYPE])
        self.dns_response_count = g(
            mn.DNS_RESPONSE_COUNT, [mn.L_QTYPE, mn.L_RCODE]
        )
        self.conntrack_packets = g(mn.CONNTRACK_PACKETS, [mn.L_DIRECTION])
        self.active_connections = g(mn.ACTIVE_CONNECTIONS, [])
        # Declared for external connectivity probers to set, exactly as
        # the reference declares them unconsumed (metrics.go:49-60).
        self.node_connectivity_status = g(
            mn.NODE_CONNECTIVITY_STATUS, ["source_node", "target_node"]
        )
        self.node_connectivity_latency = g(
            mn.NODE_CONNECTIVITY_LATENCY, ["source_node", "target_node"]
        )
        self.conntrack_bytes = g(mn.CONNTRACK_BYTES, [mn.L_DIRECTION])

        # sketch-derived node-level series
        self.distinct_flows = g(mn.DISTINCT_FLOWS, [])
        self.distinct_src_per_reason = g(
            mn.DISTINCT_SRC_PER_REASON, [mn.L_REASON]
        )
        self.entropy_bits = g(mn.ENTROPY_BITS, [mn.L_DIMENSION])
        self.anomaly_flag = g(mn.ANOMALY_FLAG, [mn.L_DIMENSION])
        self.anomaly_zscore = g(mn.ANOMALY_ZSCORE, [mn.L_DIMENSION])
        self.anomaly_windows = c(mn.ANOMALY_WINDOWS, [mn.L_DIMENSION])

        # control-plane self metrics (metrics.go:100-120)
        self.plugin_reconcile_failures = c(
            mn.PLUGIN_RECONCILE_FAILURES, [mn.L_PLUGIN]
        )
        self.lost_events = c(mn.LOST_EVENTS, [mn.L_STAGE, mn.L_PLUGIN])
        self.lost_table_entries = c(mn.LOST_TABLE_ENTRIES, [mn.L_TABLE])
        self.filter_push_failures = c(mn.FILTER_PUSH_FAILURES, [])
        self.flow_dict_entries = g(mn.FLOW_DICT_ENTRIES, [])
        self.flow_dict_generation = g(mn.FLOW_DICT_GENERATION, [])
        self.wire_rows = c(mn.WIRE_ROWS, [mn.L_KIND])
        self.parsed_packets = c(mn.PARSED_PACKETS, [mn.L_PLUGIN])
        self.device_step_seconds = ex.new_histogram(
            mn.DEVICE_STEP_SECONDS,
            [],
            buckets=[1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0],
        )
        self.device_batch_fill = g(mn.DEVICE_BATCH_FILL, [])
        self.windows_closed = c(mn.WINDOWS_CLOSED, [])
        # Window ticks deferred while the close program was still
        # queued in the background warm (stall-free close contract).
        self.windows_deferred = c(mn.WINDOWS_DEFERRED, [])
        # Sharded feed-worker backpressure (parallel/feed.py).
        self.feed_worker_fill = g(mn.FEED_WORKER_FILL, [mn.L_WORKER])
        self.feed_handoff_wait = c(mn.FEED_HANDOFF_WAIT, [mn.L_WORKER])
        self.feed_blocks_dropped = c(
            mn.FEED_BLOCKS_DROPPED, [mn.L_WORKER]
        )
        # events-in / rows-transferred of the host combiner (the kernel-map
        # aggregation factor; parallel/combine.py). 1.0 = nothing merged.
        self.combine_ratio = g(mn.COMBINE_RATIO, [])
        self.transfer_seconds = ex.new_histogram(
            mn.TRANSFER_SECONDS,
            [],
            buckets=[1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0],
        )
        self.transfer_bytes = c(mn.TRANSFER_BYTES, [])
        # Supervised-runtime robustness series (runtime/supervisor.py;
        # see metric_names for semantics).
        self.engine_restarts = c(mn.ENGINE_RESTARTS, [])
        self.watchdog_stalls = c(mn.WATCHDOG_STALLS, [mn.L_THREAD])
        self.plugin_restarts = c(mn.PLUGIN_RESTARTS, [mn.L_PLUGIN])
        self.thread_restarts = c(mn.THREAD_RESTARTS, [mn.L_THREAD])
        self.engine_errors = c(mn.ENGINE_ERRORS, [mn.L_SITE])
        self.degraded_mode = g(mn.DEGRADED_MODE, [])
        self.recovery_seconds = ex.new_histogram(
            mn.RECOVERY_SECONDS,
            [],
            buckets=[0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 60.0, 120.0],
        )
        # Adaptive overload control (runtime/overload.py; see
        # metric_names for semantics).
        self.overload_state = g(mn.OVERLOAD_STATE, [])
        self.events_sampled = c(mn.EVENTS_SAMPLED, [])
        self.events_shed = c(mn.EVENTS_SHED, [mn.L_STAGE])
        self.accuracy_debt = c(mn.ACCURACY_DEBT, [])
        # Device->host bytes (snapshot readbacks): they share the link
        # with transfer_bytes, so link-utilization math must sum both
        # directions.
        self.readback_bytes = c(mn.READBACK_BYTES, [])
        # Fleet rollup tier (fleet/; see metric_names for semantics).
        # Node-side shipper:
        self.fleet_snapshots_shipped = c(mn.FLEET_SNAPSHOTS_SHIPPED, [])
        self.fleet_ship_bytes = c(mn.FLEET_SHIP_BYTES, [])
        self.fleet_ship_deferred = c(mn.FLEET_SHIP_DEFERRED, [])
        self.fleet_ship_dropped = c(mn.FLEET_SHIP_DROPPED, [])
        self.fleet_ship_errors = c(mn.FLEET_SHIP_ERRORS, [])
        # Send-failure survival (fleet/shipper.py): spool occupancy
        # events, the replay on heal, channel re-dials, and the
        # circuit-open health gauge (1 while the relay is unreachable).
        self.fleet_ship_spooled = c(mn.FLEET_SHIP_SPOOLED, [])
        self.fleet_ship_spool_evicted = c(mn.FLEET_SHIP_SPOOL_EVICTED, [])
        self.fleet_ship_spool_replayed = c(
            mn.FLEET_SHIP_SPOOL_REPLAYED, []
        )
        self.fleet_ship_reconnects = c(mn.FLEET_SHIP_RECONNECTS, [])
        self.fleet_ship_circuit_open = g(mn.FLEET_SHIP_CIRCUIT_OPEN, [])
        # Two-level rollup: merged epochs re-shipped to the parent
        # (root) aggregator.
        self.fleet_rollups_reshipped = c(mn.FLEET_ROLLUPS_RESHIPPED, [])
        # Operator-side aggregator:
        self.fleet_snapshots_received = c(
            mn.FLEET_SNAPSHOTS_RECEIVED, [mn.L_NODE]
        )
        self.fleet_snapshots_dropped = c(
            mn.FLEET_SNAPSHOTS_DROPPED, [mn.L_REASON]
        )
        self.fleet_windows_merged = c(mn.FLEET_WINDOWS_MERGED, [])
        self.fleet_windows_stragglers = c(mn.FLEET_WINDOWS_STRAGGLERS, [])
        self.fleet_merge_errors = c(mn.FLEET_MERGE_ERRORS, [])
        self.fleet_merge_seconds = g(mn.FLEET_MERGE_SECONDS, [])
        self.fleet_nodes_reporting = g(mn.FLEET_NODES_REPORTING, [])
        # Keyed cluster families (cleared + re-published per epoch;
        # label space bounded by the fleet guardrail knobs).
        self.fleet_top_flows = g(mn.FLEET_TOP_FLOWS, [mn.L_KEY])
        self.fleet_tenant_top_flows = g(
            mn.FLEET_TENANT_TOP_FLOWS, [mn.L_TENANT, mn.L_KEY]
        )
        self.fleet_service_cardinality = g(
            mn.FLEET_SERVICE_CARDINALITY, [mn.L_SERVICE]
        )
        self.fleet_entropy_bits = g(mn.FLEET_ENTROPY_BITS, [mn.L_DIMENSION])
        self.fleet_distinct_flows = g(mn.FLEET_DISTINCT_FLOWS, [])
        self.fleet_tenant_series = g(mn.FLEET_TENANT_SERIES, [mn.L_TENANT])
        self.fleet_series_capped = c(mn.FLEET_SERIES_CAPPED, [])
        self.fleet_tenants_shed = c(mn.FLEET_TENANTS_SHED, [])
        # Invertible sketch decode (ops/invertible.py; see metric_names
        # for semantics). Node side:
        self.invertible_keys_recovered = g(mn.INVERTIBLE_KEYS_RECOVERED, [])
        self.invertible_decode_failed = c(mn.INVERTIBLE_DECODE_FAILED, [])
        self.invertible_recall = g(mn.INVERTIBLE_RECALL, [])
        self.invertible_precision = g(mn.INVERTIBLE_PRECISION, [])
        # Fleet side (cleared + re-published per epoch like the other
        # keyed cluster families):
        self.fleet_invertible_keys = g(mn.FLEET_INVERTIBLE_KEYS, [])
        self.fleet_invertible_sources = g(
            mn.FLEET_INVERTIBLE_SOURCES, [mn.L_KEY]
        )
        self.fleet_invertible_decode_failed = c(
            mn.FLEET_INVERTIBLE_DECODE_FAILED, []
        )
        # Time-travel query ring + closed-loop capture (timetravel/).
        self.timetravel_ring_appended = c(
            mn.TIMETRAVEL_RING_APPENDED, [mn.L_RING]
        )
        self.timetravel_ring_dropped = c(
            mn.TIMETRAVEL_RING_DROPPED, [mn.L_RING]
        )
        self.timetravel_ring_depth = g(
            mn.TIMETRAVEL_RING_DEPTH, [mn.L_RING]
        )
        self.timetravel_queries = c(mn.TIMETRAVEL_QUERIES, [mn.L_STATUS])
        self.timetravel_query_seconds = ex.new_histogram(
            mn.TIMETRAVEL_QUERY_SECONDS, [],
            buckets=[1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0],
        )
        self.timetravel_query_windows = g(mn.TIMETRAVEL_QUERY_WINDOWS, [])
        self.autocapture_triggered = c(mn.AUTOCAPTURE_TRIGGERED, [])
        self.autocapture_suppressed = c(
            mn.AUTOCAPTURE_SUPPRESSED, [mn.L_REASON]
        )
        self.autocapture_completed = c(mn.AUTOCAPTURE_COMPLETED, [])
        self.autocapture_failed = c(mn.AUTOCAPTURE_FAILED, [])
        self.autocapture_attributed_keys = g(mn.AUTOCAPTURE_KEYS, [])
        self.autocapture_artifact_bytes = g(
            mn.AUTOCAPTURE_ARTIFACT_BYTES, []
        )
        self.autocapture_last_epoch = g(mn.AUTOCAPTURE_LAST_EPOCH, [])
        # Pluggable detector bank (detect/): per-detector firing
        # telemetry; label space is the fixed detector registry.
        self.detector_fired = c(mn.DETECTOR_FIRED, [mn.L_DETECTOR])
        self.detector_suppressed = c(
            mn.DETECTOR_SUPPRESSED, [mn.L_DETECTOR, mn.L_REASON]
        )
        self.detector_score = g(mn.DETECTOR_SCORE, [mn.L_DETECTOR])
        self.detector_zscore = g(mn.DETECTOR_ZSCORE, [mn.L_DETECTOR])
        self.detector_last_epoch = g(
            mn.DETECTOR_LAST_EPOCH, [mn.L_DETECTOR]
        )
        # Fleet query plane (fleetquery/): scatter-gather fan-out
        # telemetry; buckets match timetravel_query_seconds so node
        # and fleet p99s read off the same grid.
        self.fleet_query_requests = c(
            mn.FLEET_QUERY_REQUESTS, [mn.L_STATUS]
        )
        self.fleet_query_seconds = ex.new_histogram(
            mn.FLEET_QUERY_SECONDS, [],
            buckets=[1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0],
        )
        self.fleet_query_nodes_answered = g(
            mn.FLEET_QUERY_NODES_ANSWERED, []
        )
        self.fleet_query_node_errors = c(
            mn.FLEET_QUERY_NODE_ERRORS, [mn.L_REASON]
        )
        self.fleet_query_hedges = c(mn.FLEET_QUERY_HEDGES, [])
        self.fleet_query_coverage = g(mn.FLEET_QUERY_COVERAGE, [])
        # Endurance soak harness (soak/runner.py): phase progress +
        # sentinel verdicts, scrapeable mid-soak.
        self.soak_phases = c(mn.TPU_SOAK_PHASES, [])
        self.soak_sentinel_failures = c(
            mn.TPU_SOAK_SENTINEL_FAILURES, [mn.L_SENTINEL]
        )
        self.soak_recovery_seconds = g(mn.TPU_SOAK_RECOVERY_SECONDS, [])
        # Flight recorder (obs/recorder.py): per-stage span latency.
        # Label space is the FIXED stage registry (mn.STAGES); buckets
        # span sub-ms host hops to multi-second device round-trips.
        self.stage_seconds = ex.new_histogram(
            mn.TPU_STAGE_SECONDS,
            [mn.L_STAGE],
            buckets=[1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2,
                     0.1, 0.3, 1.0, 3.0],
        )
        # Build identity + process uptime (set once / ticked by the
        # engine; docs/observability.md).
        self.build_info = g(
            mn.RETINA_BUILD_INFO,
            # The reference's label names, so that the series join across agents.
            ["version", "jax", "backend", "devices", "config"],
        )
        self.uptime_seconds = g(mn.TPU_UPTIME_SECONDS, [])


_singleton: Metrics | None = None
_lock = threading.Lock()


def initialize_metrics(exporter: Optional[Exporter] = None) -> Metrics:
    """Idempotent metric creation (reference InitializeMetrics)."""
    global _singleton
    with _lock:
        if _singleton is None:
            _singleton = Metrics(exporter)
        return _singleton


def get_metrics() -> Metrics:
    m = _singleton
    if m is None:
        return initialize_metrics()
    return m


def reset_for_tests() -> None:
    global _singleton
    with _lock:
        _singleton = None
