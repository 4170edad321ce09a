"""Prometheus metric name constants (a copy of retina_tpu/utils/metric_names.py).

Reference analog: pkg/utils/metric_names.go:14-36 — every exported series
carries the ``networkobservability_`` prefix; basic (node-level) names and
advanced (pod-level, ``adv_``) names are distinct families.
"""

PREFIX = "networkobservability_"

# Basic node-level metrics (default registry).
DROP_COUNT = PREFIX + "drop_count"
DROP_BYTES = PREFIX + "drop_bytes"
FORWARD_COUNT = PREFIX + "forward_count"
FORWARD_BYTES = PREFIX + "forward_bytes"
TCP_STATE = PREFIX + "tcp_state"
TCP_CONNECTION_REMOTE = PREFIX + "tcp_connection_remote"
TCP_CONNECTION_STATS = PREFIX + "tcp_connection_stats"
TCP_FLAG_COUNTERS = PREFIX + "tcp_flag_counters"
IP_CONNECTION_STATS = PREFIX + "ip_connection_stats"
UDP_CONNECTION_STATS = PREFIX + "udp_connection_stats"
INTERFACE_STATS = PREFIX + "interface_stats"
INFINIBAND_COUNTER_STATS = PREFIX + "infiniband_counter_stats"
INFINIBAND_STATUS_PARAMS = PREFIX + "infiniband_status_params"
DNS_REQUEST_COUNT = PREFIX + "dns_request_count"
DNS_RESPONSE_COUNT = PREFIX + "dns_response_count"
NODE_CONNECTIVITY_STATUS = PREFIX + "node_connectivity_status"
NODE_CONNECTIVITY_LATENCY = PREFIX + "node_connectivity_latency_seconds"
CONNTRACK_PACKETS = PREFIX + "conntrack_packets"
CONNTRACK_BYTES = PREFIX + "conntrack_bytes"

# Advanced pod-level metrics (resettable advanced registry).
ADV_PREFIX = PREFIX + "adv_"
ADV_FORWARD_COUNT = ADV_PREFIX + "forward_count"
ADV_FORWARD_BYTES = ADV_PREFIX + "forward_bytes"
ADV_DROP_COUNT = ADV_PREFIX + "drop_count"
ADV_DROP_BYTES = ADV_PREFIX + "drop_bytes"
ADV_TCP_FLAG_COUNTERS = ADV_PREFIX + "tcpflags_count"
ADV_TCP_RETRANS_COUNT = ADV_PREFIX + "tcpretrans_count"
ADV_DNS_REQUEST_COUNT = ADV_PREFIX + "dns_request_count"
ADV_DNS_RESPONSE_COUNT = ADV_PREFIX + "dns_response_count"
ADV_API_LATENCY = ADV_PREFIX + "node_apiserver_latency"
ADV_API_NO_RESPONSE = ADV_PREFIX + "node_apiserver_no_response"

# Sketch-derived series (new in the TPU framework).
SKETCH_PREFIX = PREFIX + "sketch_"
HEAVY_HITTER_FLOWS = SKETCH_PREFIX + "heavy_hitter_flow_packets"
HEAVY_HITTER_SERVICES = SKETCH_PREFIX + "service_graph_packets"
HEAVY_HITTER_DNS = SKETCH_PREFIX + "dns_heavy_hitter_count"
DISTINCT_FLOWS = SKETCH_PREFIX + "distinct_flows"
DISTINCT_SRC_PER_REASON = SKETCH_PREFIX + "distinct_sources_per_drop_reason"
DISTINCT_SRC_PER_POD = SKETCH_PREFIX + "distinct_sources_per_pod"
ENTROPY_BITS = SKETCH_PREFIX + "entropy_bits"
ANOMALY_FLAG = SKETCH_PREFIX + "anomaly_flag"
ANOMALY_ZSCORE = SKETCH_PREFIX + "anomaly_zscore"
# Monotonic count of anomalous windows: the flag gauge only shows
# the CURRENT window, which a 10-30s scrape cadence would miss for
# sub-second windows.
ANOMALY_WINDOWS = SKETCH_PREFIX + "anomaly_windows_total"
ACTIVE_CONNECTIONS = PREFIX + "conntrack_active_connections"

# Control-plane self metrics (reference pkg/metrics/metrics.go:14-120).
PLUGIN_RECONCILE_FAILURES = PREFIX + "plugin_manager_failed_to_reconcile"
LOST_EVENTS = PREFIX + "lost_events_counter"
# Table entries (filter IPs / pod identities) dropped because a
# fixed-capacity device table was full — the agent clamps and stays up
# (reference counts per-IP map-write failures the same way,
# manager_linux.go:62-100).
LOST_TABLE_ENTRIES = PREFIX + "lost_table_entries_counter"
# Filter-map device pushes that exhausted every retry (transient device
# failure outlasting the backoff): the device filter set is stale until
# the next successful push — invisible without this counter.
FILTER_PUSH_FAILURES = PREFIX + "filter_push_failures_counter"
# v2-wire flow dictionary self-observability: resident descriptors,
# generation (bumps = capacity cycles or failure resyncs), and wire
# rows by kind — known/new ratio IS the wire savings factor.
FLOW_DICT_ENTRIES = PREFIX + "tpu_flow_dict_entries"
FLOW_DICT_GENERATION = PREFIX + "tpu_flow_dict_generation"
WIRE_ROWS = PREFIX + "tpu_wire_rows_counter"
L_KIND = "kind"
PARSED_PACKETS = PREFIX + "parsed_packets_counter"
# Sharded feed-worker backpressure (parallel/feed.py): per-worker
# quantum fill at flush, seconds spent waiting for a free handoff slot
# (a persistently growing wait means the dispatch/device side is the
# bottleneck, not the host), and blocks dropped because every worker's
# staging was full.
FEED_WORKER_FILL = PREFIX + "tpu_feed_worker_fill_ratio"
FEED_HANDOFF_WAIT = PREFIX + "tpu_feed_handoff_wait_seconds"
FEED_BLOCKS_DROPPED = PREFIX + "tpu_feed_blocks_dropped"
L_WORKER = "worker"
# Window ticks deferred because the close program was still queued in
# the background warm (engine._close_window_impl): the window stays
# open instead of cold-compiling end_window inline mid-feed.
WINDOWS_DEFERRED = PREFIX + "tpu_windows_deferred"
# Supervised-runtime robustness counters (runtime/supervisor.py).
# engine_restarts counts full crash-only engine recoveries (device
# state rebuilt, resumed from the last checkpoint); watchdog_stalls
# counts missed-heartbeat escalations per thread; plugin_restarts and
# thread_restarts count supervised restarts of plugin runners and of
# engine-internal threads; engine_errors is the named-counter side of
# the broad-except audit (every swallow bumps a site label);
# degraded_mode is 1 while the engine is dropping-and-counting during
# a recovery; recovery_seconds is the teardown→re-warm→resume latency.
ENGINE_RESTARTS = PREFIX + "tpu_engine_restarts"
WATCHDOG_STALLS = PREFIX + "watchdog_stalls_counter"
PLUGIN_RESTARTS = PREFIX + "plugin_restarts_counter"
THREAD_RESTARTS = PREFIX + "thread_restarts_counter"
ENGINE_ERRORS = PREFIX + "engine_errors_counter"
DEGRADED_MODE = PREFIX + "tpu_degraded_mode"
RECOVERY_SECONDS = PREFIX + "tpu_recovery_seconds"
# Adaptive overload control (runtime/overload.py). overload_state is
# the controller state as a number (0=NOMINAL 1=SAMPLING 2=SHEDDING
# 3=DEGRADED); events_sampled counts raw (packet-weighted) events
# dropped by the feed-worker 1-in-k sampler and re-represented on
# device by x k rescaling; events_shed counts shed enrichment work per
# stage (events for dns, passes for conntrack/labels, raw handoff
# drops under stage="raw"); accuracy_debt is the cumulative packet
# weight SYNTHESIZED by the device rescaling — the estimated (not
# observed) share of the sketch totals.
OVERLOAD_STATE = PREFIX + "tpu_overload_state"
EVENTS_SAMPLED = PREFIX + "tpu_events_sampled_counter"
EVENTS_SHED = PREFIX + "tpu_events_shed_counter"
ACCURACY_DEBT = PREFIX + "tpu_accuracy_debt_counter"
DEVICE_STEP_SECONDS = PREFIX + "tpu_step_seconds"
DEVICE_BATCH_FILL = PREFIX + "tpu_batch_fill_ratio"
WINDOWS_CLOSED = PREFIX + "tpu_windows_closed"
COMBINE_RATIO = PREFIX + "host_combine_ratio"
TRANSFER_SECONDS = PREFIX + "tpu_transfer_seconds"
TRANSFER_BYTES = PREFIX + "tpu_transfer_bytes"
READBACK_BYTES = PREFIX + "tpu_readback_bytes"

# Fleet rollup tier (fleet/): cluster-wide series published by the
# operator-side aggregator, plus node-side shipper self-metrics.
# Shipper: snapshots_shipped counts frames actually sent;
# ship_bytes the encoded wire bytes; ship_deferred windows skipped by
# the SHEDDING backoff (1-in-fleet_shed_ship_every); ship_dropped
# windows lost to a full ship queue; ship_errors failed sends.
# Aggregator: snapshots_received{node} accepted frames;
# snapshots_dropped{reason} rejects (decode/late/duplicate/
# seed_mismatch/shape_mismatch); windows_merged closed epochs;
# windows_stragglers epochs closed by timeout instead of quorum;
# merge_errors failed poll/merge passes; merge_seconds the last
# epoch's merge wall time; nodes_reporting the node count of the last
# merged epoch. Keyed families are cleared and re-published per epoch
# so their label space is bounded by the guardrail knobs:
# top_flow_packets{key} <= fleet_topk_k series,
# tenant_top_flow_packets{tenant,key} <= fleet_tenant_series_max per
# tenant over <= fleet_max_tenants tenants (tenant_series{tenant}
# reports each tenant's exported count; series_capped/tenants_shed
# count guardrail enforcement), service_cardinality{service} <=
# fleet_service_top series; entropy_bits{dimension} and
# distinct_flows are fixed-cardinality cluster estimates.
FLEET_PREFIX = PREFIX + "fleet_"
FLEET_SNAPSHOTS_SHIPPED = FLEET_PREFIX + "snapshots_shipped_counter"
FLEET_SHIP_BYTES = FLEET_PREFIX + "ship_bytes_counter"
FLEET_SHIP_DEFERRED = FLEET_PREFIX + "ship_deferred_counter"
FLEET_SHIP_DROPPED = FLEET_PREFIX + "ship_dropped_counter"
FLEET_SHIP_ERRORS = FLEET_PREFIX + "ship_errors_counter"
FLEET_SHIP_SPOOLED = FLEET_PREFIX + "ship_spooled_counter"
FLEET_SHIP_SPOOL_EVICTED = FLEET_PREFIX + "ship_spool_evicted_counter"
FLEET_SHIP_SPOOL_REPLAYED = FLEET_PREFIX + "ship_spool_replayed_counter"
FLEET_SHIP_RECONNECTS = FLEET_PREFIX + "ship_reconnects_counter"
FLEET_SHIP_CIRCUIT_OPEN = FLEET_PREFIX + "ship_circuit_open"
FLEET_ROLLUPS_RESHIPPED = FLEET_PREFIX + "rollups_reshipped_counter"
FLEET_SNAPSHOTS_RECEIVED = FLEET_PREFIX + "snapshots_received_counter"
FLEET_SNAPSHOTS_DROPPED = FLEET_PREFIX + "snapshots_dropped_counter"
FLEET_WINDOWS_MERGED = FLEET_PREFIX + "windows_merged_counter"
FLEET_WINDOWS_STRAGGLERS = FLEET_PREFIX + "windows_stragglers_counter"
FLEET_MERGE_ERRORS = FLEET_PREFIX + "merge_errors_counter"
FLEET_MERGE_SECONDS = FLEET_PREFIX + "merge_seconds"
FLEET_NODES_REPORTING = FLEET_PREFIX + "nodes_reporting"
FLEET_TOP_FLOWS = FLEET_PREFIX + "top_flow_packets"
FLEET_TENANT_TOP_FLOWS = FLEET_PREFIX + "tenant_top_flow_packets"
FLEET_SERVICE_CARDINALITY = FLEET_PREFIX + "service_cardinality"
FLEET_ENTROPY_BITS = FLEET_PREFIX + "entropy_bits"
FLEET_DISTINCT_FLOWS = FLEET_PREFIX + "distinct_flows"
FLEET_TENANT_SERIES = FLEET_PREFIX + "tenant_series"
FLEET_SERIES_CAPPED = FLEET_PREFIX + "series_capped_counter"
FLEET_TENANTS_SHED = FLEET_PREFIX + "tenants_shed_counter"

# Invertible sketch (ops/invertible.py): heavy-flow keys recovered from
# sketch state at window close. Node side (tpu_invertible_*):
# keys_recovered is the last window's verified decoded-key count;
# decode_failed counts decode dispatch errors; recall/precision are
# scored against the host flow-dict ground truth and only published in
# heavy_keys_source="both" validation mode. Fleet side
# (fleet_invertible_*): keys_recovered is the last epoch's cluster-wide
# decoded-key count from MERGED sketch state (no node shipped raw
# keys); source_packets{key} attributes decoded heavy traffic to source
# IPs (DDoS attribution, cleared+republished per epoch, <= fleet_topk_k
# series); decode_failed counts merged-state decode errors.
INVERTIBLE_KEYS_RECOVERED = PREFIX + "tpu_invertible_keys_recovered"
INVERTIBLE_DECODE_FAILED = PREFIX + "tpu_invertible_decode_failed_counter"
INVERTIBLE_RECALL = PREFIX + "tpu_invertible_recall"
INVERTIBLE_PRECISION = PREFIX + "tpu_invertible_precision"
FLEET_INVERTIBLE_KEYS = FLEET_PREFIX + "invertible_keys_recovered"
FLEET_INVERTIBLE_SOURCES = FLEET_PREFIX + "invertible_source_packets"
FLEET_INVERTIBLE_DECODE_FAILED = (
    FLEET_PREFIX + "invertible_decode_failed_counter"
)

# Time-travel query ring (retina_tpu/timetravel): ring_appended/
# ring_dropped/ring_depth track each bounded snapshot ring (label
# ring=engine|fleet — fixed set, one per producer); queries counts
# range-query requests by terminal status (ok/stale/busy/empty/
# bad_request/error — fixed set), query_seconds is the HTTP handler
# latency histogram the p99 bound is read from, query_windows the slot
# count folded by the last query.
TIMETRAVEL_PREFIX = PREFIX + "tpu_timetravel_"
TIMETRAVEL_RING_APPENDED = TIMETRAVEL_PREFIX + "ring_appended_counter"
TIMETRAVEL_RING_DROPPED = TIMETRAVEL_PREFIX + "ring_dropped_counter"
TIMETRAVEL_RING_DEPTH = TIMETRAVEL_PREFIX + "ring_depth"
TIMETRAVEL_QUERIES = TIMETRAVEL_PREFIX + "queries_counter"
TIMETRAVEL_QUERY_SECONDS = TIMETRAVEL_PREFIX + "query_seconds"
TIMETRAVEL_QUERY_WINDOWS = TIMETRAVEL_PREFIX + "query_windows"

# Closed-loop capture (timetravel/autocapture.py): triggered counts
# detector firings accepted for capture; suppressed counts firings
# absorbed by reason (cooldown/busy/no_keys — fixed set); completed/
# failed count finished capture jobs; attributed_keys and
# artifact_bytes describe the last completed capture; last_epoch is
# the burst window-epoch it covered.
AUTOCAPTURE_PREFIX = PREFIX + "tpu_autocapture_"
AUTOCAPTURE_TRIGGERED = AUTOCAPTURE_PREFIX + "triggered_counter"
AUTOCAPTURE_SUPPRESSED = AUTOCAPTURE_PREFIX + "suppressed_counter"
AUTOCAPTURE_COMPLETED = AUTOCAPTURE_PREFIX + "completed_counter"
AUTOCAPTURE_FAILED = AUTOCAPTURE_PREFIX + "failed_counter"
AUTOCAPTURE_KEYS = AUTOCAPTURE_PREFIX + "attributed_keys"
AUTOCAPTURE_ARTIFACT_BYTES = AUTOCAPTURE_PREFIX + "artifact_bytes"
AUTOCAPTURE_LAST_EPOCH = AUTOCAPTURE_PREFIX + "last_epoch"

# Pluggable detector bank (retina_tpu/detect/): fired counts accepted
# firings per detector (the ones handed to the capture sink);
# suppressed counts firings absorbed by reason (cooldown/warmup/
# disabled — fixed set); score is the last raw detector statistic
# (ports-per-source estimate, qname-length entropy bits, SYN:ACK
# ratio), zscore the EWMA z it was judged by; last_epoch is the last
# window-epoch each detector fired on.
DETECTOR_PREFIX = PREFIX + "tpu_detector_"
DETECTOR_FIRED = DETECTOR_PREFIX + "fired_counter"
DETECTOR_SUPPRESSED = DETECTOR_PREFIX + "suppressed_counter"
DETECTOR_SCORE = DETECTOR_PREFIX + "score"
DETECTOR_ZSCORE = DETECTOR_PREFIX + "zscore"
DETECTOR_LAST_EPOCH = DETECTOR_PREFIX + "last_epoch"

# Fleet query plane (retina_tpu/fleetquery/): requests counts
# /fleet/query requests by terminal status (ok/partial/stale/busy/
# empty/bad_request/error — fixed set), seconds is the handler latency
# histogram the fleet p99 bound is read from; nodes_answered is the
# per-gather answered-node count and coverage_ratio the matching
# answered/total fraction (1.0 = full coverage); node_errors counts
# per-node scatter failures by reason (timeout/dead/seed_mismatch —
# fixed set); hedges counts hedged second attempts issued.
FLEET_QUERY_PREFIX = PREFIX + "fleet_query_"
FLEET_QUERY_REQUESTS = FLEET_QUERY_PREFIX + "requests_counter"
FLEET_QUERY_SECONDS = FLEET_QUERY_PREFIX + "seconds"
FLEET_QUERY_NODES_ANSWERED = FLEET_QUERY_PREFIX + "nodes_answered"
FLEET_QUERY_NODE_ERRORS = FLEET_QUERY_PREFIX + "node_errors_counter"
FLEET_QUERY_HEDGES = FLEET_QUERY_PREFIX + "hedges_counter"
FLEET_QUERY_COVERAGE = FLEET_QUERY_PREFIX + "coverage_ratio"

# Endurance soak harness (retina_tpu/soak/): phase progress and
# sentinel verdicts for a live `bench.py --soak` run, scrapeable
# mid-soak so an operator (or the alert rules) can watch a multi-hour
# run without waiting for the SOAK_*.json artifact. `sentinel` is the
# fixed verdict set the runner evaluates (rss_flat, fd_churn,
# stalled_windows, recorder, aot_cache, overload_recovery);
# last_recovery_seconds is the most recent fault-clear -> NOMINAL
# latency.
TPU_SOAK_PREFIX = PREFIX + "tpu_soak_"
TPU_SOAK_PHASES = TPU_SOAK_PREFIX + "phases_completed_counter"
TPU_SOAK_SENTINEL_FAILURES = TPU_SOAK_PREFIX + "sentinel_failures_counter"
TPU_SOAK_RECOVERY_SECONDS = TPU_SOAK_PREFIX + "last_recovery_seconds"

# Flight recorder (retina_tpu/obs/): per-window stage-latency
# breakdown. tpu_stage_seconds{stage} is observed once per SAMPLED span
# by the recorder; build_info is a constant-1 gauge whose labels
# identify the running build (version/jax/backend/devices/config
# signature — the scrape-side answer to "what exactly is running?");
# uptime_seconds is seconds since engine start.
TPU_STAGE_SECONDS = PREFIX + "tpu_stage_seconds"
RETINA_BUILD_INFO = PREFIX + "retina_build_info"
TPU_UPTIME_SECONDS = PREFIX + "tpu_uptime_seconds"

# Pipeline stage-name registry (the ONLY legal values of the
# tpu_stage_seconds `stage` label and of every recorder span). The
# RT226 analyzer machine-checks three-way agreement between these
# constants, the span names actually emitted through the recorder, and
# the stage table in docs/observability.md — add the constant, the
# emission site and the doc row together.
STAGE_GENERATOR_EMIT = "generator_emit"
STAGE_COMBINE = "combine"
STAGE_FEED_FILL = "feed_fill"
STAGE_STAGING_HANDOFF = "staging_handoff"
STAGE_WIRE_BUILD = "wire_build"
STAGE_TRANSFER = "transfer"
STAGE_DEVICE_STEP = "device_step"
STAGE_WINDOW_CLOSE = "window_close"
STAGE_HARVEST = "harvest"
STAGE_PUBLISH = "publish"
STAGE_SHIP_READBACK = "ship_readback"
STAGE_SHIP_ENCODE = "ship_encode"
STAGE_SHIP_SEND = "ship_send"
STAGE_AGG_MERGE = "aggregator_merge"

# Ordered registry (pipeline order); drives the fixed label space of
# tpu_stage_seconds and the bench critical-path report.
STAGES = (
    STAGE_GENERATOR_EMIT,
    STAGE_COMBINE,
    STAGE_FEED_FILL,
    STAGE_STAGING_HANDOFF,
    STAGE_WIRE_BUILD,
    STAGE_TRANSFER,
    STAGE_DEVICE_STEP,
    STAGE_WINDOW_CLOSE,
    STAGE_HARVEST,
    STAGE_PUBLISH,
    STAGE_SHIP_READBACK,
    STAGE_SHIP_ENCODE,
    STAGE_SHIP_SEND,
    STAGE_AGG_MERGE,
)

# Label keys (reference pkg/utils/metric_names.go label constants).
L_DIRECTION = "direction"
L_REASON = "reason"
L_FLAG = "flag"
L_POD = "podname"
L_NAMESPACE = "namespace"
L_WORKLOAD = "workload_kind"
L_IP = "ip"
L_PORT = "port"
L_PROTO = "protocol"
L_QTYPE = "query_type"
L_RCODE = "return_code"
L_DIMENSION = "dimension"
L_STAGE = "stage"
L_TABLE = "table"
L_PLUGIN = "plugin"
L_STATE = "state"
L_THREAD = "thread"
L_SITE = "site"
L_INTERFACE = "interface_name"
L_STAT = "statistic_name"
L_BUCKET = "le_ms"
L_TENANT = "tenant"
L_KEY = "key"
L_NODE = "node"
L_SERVICE = "service"
L_RING = "ring"
L_STATUS = "status"
L_SENTINEL = "sentinel"
L_DETECTOR = "detector"
