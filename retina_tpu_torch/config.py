"""Layered agent configuration (port of retina_tpu/config.py).

Reference analog: pkg/config/config.go:59-125 — viper merges a YAML file
with ``RETINA_``-prefixed environment variables into one static ``Config``
struct consumed by the daemon. Same layering here: dataclass defaults ←
YAML file ← ``RETINA_*`` env vars ← explicit overrides, via
:func:`load_config` (PyYAML is imported only when a file is named).

``Config`` holds the fields the port reads, with the reference's names,
defaults and checks, so ``Config()`` is the deployed node agent: the
daemon's, the plugins', the watchers' and the CLI's fields (the HTTP
address, the enabled plugins, the event source, telemetry and logging),
the pipeline shapes that ``engine.pipeline_config_from`` turns into a
``PipelineConfig``, the feed path's knobs (batch capacity, combining,
coalescing, transfer buckets and the wire format), the window, the
time-travel ring and its query route, the fleet rollup tier (the node's
shipper, the aggregator and its relay transport) and the fleet query plane,
the detector bank and the closed-loop capture, the /metrics render cache, the runtime
lanes and the overload controller, and the supervised runtime
(checkpoints, the watchdog, the restart policy, fault injection and the
flight recorder). ``device_platform`` names the torch device: "" is the
card (and raises without one), "cpu" the plain versions on the host.

The reference's JAX-only fields (``compilation_cache_dir``, the
``distributed_num_processes``/``process_id`` pair, the AOT cache) and its
profiling fields are not copied; ``load_config`` ignores unknown keys as
the reference does, so an older YAML still loads. The switch of a part
the port does not have yet (``distributed_coordinator``) is kept so that
the daemon can refuse it.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any

AGG_LOW = "low"
AGG_HIGH = "high"

DEFAULT_PLUGINS = ["packetparser", "dropreason", "packetforward", "dns"]

# The torch devices ``device_platform`` may name ("" = the card).
DEVICE_PLATFORMS = ("", "cpu", "cuda")


@dataclasses.dataclass
class Config:
    """Static agent configuration (the reference's ``Config``, the fields
    the port reads)."""

    # --- reference-parity fields ---
    api_server_addr: str = "127.0.0.1:10093"
    enabled_plugins: list[str] = dataclasses.field(
        default_factory=lambda: list(DEFAULT_PLUGINS)
    )
    metrics_interval_s: float = 10.0  # map-read plugin cadence
    # /metrics render cache TTL (gauges change only at the publish
    # cadence); 0 renders every scrape.
    metrics_cache_ttl_s: float = 0.5
    enable_telemetry: bool = False
    enable_pod_level: bool = True
    enable_annotations: bool = False
    enable_conntrack_metrics: bool = True
    bypass_lookup_ip_of_interest: bool = False
    data_aggregation_level: str = AGG_LOW
    telemetry_interval_s: float = 900.0
    enable_hubble: bool = False  # flow-relay control plane (cmd/hubble)
    hubble_addr: str = "127.0.0.1:4244"
    hubble_ring_capacity: int = 1 << 12
    # Dedicated hubble metrics mux (reference :9965); "" disables.
    hubble_metrics_addr: str = ""
    # TLS for the flow relay (reference hubble TLS options). PEM paths;
    # client CA set => mutual TLS required.
    hubble_tls_cert: str = ""
    hubble_tls_key: str = ""
    hubble_tls_client_ca: str = ""
    # Local-client unix endpoint beside TCP (the reference serves
    # unix:///var/run/cilium/hubble.sock, SURVEY §3.5). "" disables.
    hubble_sock_path: str = ""
    # Static peer list for the peer service: [{"name", "address"}].
    hubble_peers: list = dataclasses.field(default_factory=list)
    node_name: str = ""
    # Identity from a real cluster: core/v1 pods/services/nodes list+watch
    # feeding the cache (pkg/k8s watcher analog), and the agent's CRD
    # bridge. "" = in-process only, unless an in-cluster service account
    # is mounted.
    kubeconfig: str = ""
    kube_namespace: str = ""  # namespace scope for pod/service watches
    # Pod identity source when watching a cluster: "pods" (core/v1) or
    # "cilium" (consume the Cilium CNI's CiliumEndpoints — the
    # cilium-crds interop mode; services/nodes still come from core/v1).
    identity_source: str = "pods"
    # A multi-process mesh ("host:port" of process 0): not ported; the
    # daemon refuses it.
    distributed_coordinator: str = ""
    log_level: str = "info"
    log_file: str = ""  # empty = stderr only

    # --- event source (the kernel-hook analog) ---
    event_source: str = "synthetic"  # synthetic | pcap | live
    pcap_path: str = ""  # replay file for event_source=pcap
    pcap_loop: bool = True  # loop the replay
    synthetic_rate: float = 1e6  # target events/s for the generator
    synthetic_flows: int = 100_000
    # Pre-generate this many 8192-event blocks and cycle them in the feed
    # loop (0 = generate live).
    synthetic_pregen: int = 0
    # Generator regime preset (events/synthetic.py PRESETS).
    gen_preset: str = "default"
    capture_iface: str = ""  # live AF_PACKET interface ("" = default)
    external_socket: str = "/tmp/retina-events.sock"  # externalevents' feed
    # Cilium agent monitor socket (gob payload stream) for the
    # ciliumeventobserver plugin (reference config.go MonitorSockPath).
    monitor_sock_path: str = "/var/run/cilium/monitor1_2.sock"

    # --- the device ---
    # The torch device the agent runs on: "" = the card (raises without
    # one), "cpu" = the plain versions on the host.
    device_platform: str = ""

    # --- the feed path ---
    batch_capacity: int = 1 << 15  # events per device batch (one step)
    # The cap on the engine's shards (one a local card): 0 = every local card.
    mesh_devices: int = 0
    window_seconds: float = 1.0  # entropy/anomaly window; fleet epochs are its multiples
    # Host-side combining of identical descriptors before the transfer
    # (parallel/combine.py); lossless.
    host_combine: bool = True
    # Threads of the native combiner; 0 = cores-1 capped at 4.
    host_combine_threads: int = 0
    # The feed loop flushes its staged blocks at this age while no
    # dispatch is in flight (latency), and at flush_max_age_s however busy
    # the card is; or as soon as flush_max_events raw events are staged.
    flush_interval_s: float = 0.05
    flush_max_age_s: float = 0.4
    flush_max_events: int = 1 << 21
    # Dispatches in flight on the device proxy (the dispatch thread packs
    # batch N+1 while N crosses); 0 = synchronous dispatch on the feed
    # loop's thread, with no dispatch thread and no feed workers.
    feed_pipeline_depth: int = 3
    # Feed workers that combine and partition in parallel; 0 = cores-1
    # capped at 4, <= 1 the inline feed. Raw sink blocks a worker stages
    # before the distributor drops (and counts) a block.
    feed_workers: int = 0
    feed_staging_blocks: int = 1024
    # Windows of batch_capacity carried by one host-to-card transfer.
    feed_coalesce_windows: int = 4
    # Smallest transfer bucket; flushes below it take the packed wire.
    transfer_min_bucket: int = 1 << 12
    # The 12-lane packed wire (parallel/wire.py) instead of 16 lanes.
    transfer_packed: bool = True
    # The flow-descriptor dictionary wire (parallel/flowdict.py).
    wire_flow_dict: bool = True
    # Known rows as the dense (id_bits + 10 + 22)-bit stream (v4) instead
    # of two u32 lanes (v3).
    wire_dense_known: bool = True
    # Slots of the card's descriptor table (48 B each).
    flow_dict_slots: int = 1 << 18

    snapshot_dir: str = ""  # sketch-state checkpoint dir ("" = off)
    snapshot_interval_s: float = 0.0  # 0 = only on shutdown

    # --- the supervised runtime (runtime/supervisor.py) ---
    # A registered thread that neither beats nor parks for this long is a
    # stall: counted in watchdog_stalls and escalated (a hung harvest
    # thread is replaced). Also the bound on the recovery path's fence.
    watchdog_deadline_s: float = 30.0
    watchdog_interval_s: float = 0.5  # the watchdog's scan cadence
    # The bound on draining the harvest at shutdown.
    harvest_timeout_s: float = 30.0
    # Restart policy: exponential backoff base/cap with multiplicative
    # jitter; after restart_max_failures consecutive crashes inside
    # restart_window_s the circuit OPENS (the thread is no longer
    # restarted; engine recovery latches recovery_failed) and half-open
    # probes run every circuit_half_open_s until one stays healthy.
    restart_backoff_base_s: float = 0.2
    restart_backoff_max_s: float = 30.0
    restart_backoff_jitter: float = 0.2
    restart_max_failures: int = 5
    restart_window_s: float = 60.0
    circuit_half_open_s: float = 30.0
    # Deterministic fault injection (runtime/faults.py), e.g.
    # "transfer:raise@3,recover:hang30". Empty = disarmed.
    fault_spec: str = ""

    # --- adaptive overload control (runtime/overload.py) ---
    overload_enabled: bool = True
    overload_tick_s: float = 0.1  # the controller's cadence
    # 1-in-k sampling of non-exempt combined rows in SAMPLING and above;
    # the step rescales the survivors by k (Horvitz-Thompson).
    overload_sample_k: int = 8
    # Rows of at least this many packets are heavy-hitter candidates,
    # never sampled and never rescaled.
    overload_exempt_packets: int = 64
    # Hysteresis on the [0, 1] pressure: immediate escalation at enter,
    # shed and degrade; one level down per dwell_s at or below exit.
    overload_enter_pressure: float = 0.75
    overload_exit_pressure: float = 0.45
    overload_shed_pressure: float = 0.90
    overload_degrade_pressure: float = 0.98
    overload_dwell_s: float = 2.0
    overload_shed_escalate_s: float = 1.0  # SHEDDING widens a stage per this
    overload_shed_order: list[str] = dataclasses.field(
        default_factory=lambda: ["dns", "conntrack", "labels"]
    )

    # --- priority class and the invertible sketch ---
    overload_priority_ip_mask: int = 0
    overload_priority_ip_match: int = 0
    # Where heavy-flow keys come from: "flowdict", "invertible" or "both".
    heavy_keys_source: str = "flowdict"
    invertible_depth: int = 2
    invertible_width: int = 1 << 12
    invertible_hi_width: int = 1 << 9
    invertible_min_weight: int = 0

    # --- pipeline shapes ---
    n_pods: int = 1 << 12
    cms_width: int = 1 << 15
    cms_depth: int = 4
    topk_slots: int = 1 << 11
    hll_precision: int = 12
    entropy_buckets: int = 1 << 12
    conntrack_slots: int = 1 << 18
    identity_slots: int = 1 << 16

    # --- the fleet rollup tier (fleet/) ---
    # Node side: ship the window-close sketch export (fleet/shipper.py).
    fleet_enabled: bool = False
    # Operator side: run the FleetAggregator (the epoch-aligned merge on
    # the card and the fleet_* families). Both may be on in one process:
    # the in-process pubsub transport loops back.
    fleet_aggregator: bool = False
    fleet_node_name: str = ""  # wire identity ("" = node_name or pid)
    fleet_tenant: str = "default"
    # Higher priority tenants are shed last by the cardinality guardrails.
    fleet_priority: int = 0
    # gRPC Ship target ("host:port"); "" ships over the in-process bus.
    fleet_relay_addr: str = ""
    # Close an epoch once this many nodes reported; 0 = on the timeout only.
    fleet_expected_nodes: int = 0
    # Epoch close deadline after the first arrival.
    fleet_straggler_timeout_s: float = 2.0
    # Open epochs buffered before the oldest is force-closed.
    fleet_epoch_history: int = 8
    # Node-side ship queue depth; a full queue drops the snapshot (never
    # blocks the window close).
    fleet_ship_queue: int = 4
    # Under SHEDDING and above, ship only 1 window in this many.
    fleet_shed_ship_every: int = 4
    # Seed generation stamped on shipped frames; bump it when rotating the
    # sketch seeds so the aggregator re-admits the node under the new one.
    fleet_seed_generation: int = 0
    # Send-failure spool: frames held while the relay is unreachable,
    # replayed oldest first on heal, the oldest evicted (and counted) when
    # full. 0 turns spooling off (a failed send is dropped, counted).
    fleet_ship_spool: int = 64
    # Jittered exponential backoff between send retries while the ship
    # circuit is open: uniform in [base/2, min(max, base * 2^n)].
    fleet_ship_backoff_base_s: float = 0.05
    fleet_ship_backoff_max_s: float = 2.0
    # Two-level rollup: re-ship each merged epoch as an RFLT snapshot to a
    # parent aggregator's relay at this address; "" = this is the root.
    fleet_reship_addr: str = ""
    # Merge quorum-closed epochs on the poll thread instead of in ingest.
    fleet_merge_async: bool = False
    fleet_topk_k: int = 32  # cluster-wide heavy-hitter series cap
    fleet_service_top: int = 16  # per-service cardinality series cap
    fleet_tenant_series_max: int = 64  # per-tenant series cap
    fleet_max_tenants: int = 16  # tenants per epoch; lowest priority shed first

    # --- the time-travel ring (timetravel/) ---
    # Keep the last N window-close exports in a ring for range queries.
    timetravel_enabled: bool = False
    timetravel_ring_windows: int = 32  # ring capacity (slots)
    # Range-query result cache TTL: at most one fold runs at a time and the
    # rest are served from the cache; under SHEDDING any cached result
    # serves.
    timetravel_query_cache_ttl_s: float = 1.0
    timetravel_query_topk: int = 32  # default k for /timetravel/query

    # --- closed-loop capture (timetravel/autocapture.py) ---
    autocapture_enabled: bool = False
    # On a detection, range-query the ring around the burst window W,
    # attribute sources by the invertible decode and capture only them.
    autocapture_cooldown_s: float = 60.0  # min spacing between captures
    # Query range around W: [W - lookback, W + lookahead].
    autocapture_lookback_windows: int = 2
    autocapture_lookahead_windows: int = 1
    autocapture_max_sources: int = 8  # top attributed src IPs captured
    autocapture_duration_s: float = 2.0  # capture recording window
    autocapture_max_size_mb: int = 8  # evidence bound
    # Artifact directory (capture host_path output).
    autocapture_output_dir: str = "/tmp/retina-autocapture"

    # --- the fleet query plane (fleetquery/) ---
    # GET /fleet/query: federated [t0, t1) range queries over the nodes'
    # rings (scatter-gather) or the aggregator's merged-epoch ring, with
    # the node tier's latency contract plus a per-node deadline, one hedged
    # retry and partial coverage.
    fleetquery_enabled: bool = False
    fleetquery_node_deadline_s: float = 0.25  # per-node answer budget
    # After this long with nodes unanswered, ONE hedged duplicate request
    # a straggler.
    fleetquery_hedge_delay_s: float = 0.05
    fleetquery_fanout: int = 16  # scatter pool concurrency bound
    fleetquery_cache_ttl_s: float = 1.0  # fleet result cache TTL
    fleetquery_topk: int = 32  # default k for /fleet/query

    # --- the detector bank (detect/) ---
    # Derived detectors over the engine's record tap; the window's winner
    # feeds the same AutoCapture sink as the entropy anomaly flags.
    detectors_enabled: bool = False
    detector_cooldown_s: float = 60.0  # per-detector min firing spacing
    detector_z_thresh: float = 8.0  # adaptive (EWMA z-flag) threshold
    detector_min_windows: int = 3  # EWMA warmup before z-flags count

    # --- the flight recorder (obs/recorder.py) ---
    # Always-on span recorder over every pipeline stage; off only for A/B
    # overhead measurement.
    trace_enabled: bool = True
    trace_sample_every: int = 1  # record 1 span in this many per thread
    trace_ring_spans: int = 4096  # per-thread span ring capacity

    def validate(self) -> None:
        """The reference's checks on these fields."""
        if self.identity_source not in ("pods", "cilium"):
            raise ValueError(
                f"identity_source must be 'pods' or 'cilium', "
                f"got {self.identity_source!r}"
            )
        if self.data_aggregation_level not in (AGG_LOW, AGG_HIGH):
            raise ValueError(
                f"dataAggregationLevel must be {AGG_LOW!r} or {AGG_HIGH!r}, "
                f"got {self.data_aggregation_level!r}"
            )
        if self.mesh_devices < 0:
            raise ValueError(f"mesh_devices must be >= 0, got {self.mesh_devices}")
        for f in ("batch_capacity", "n_pods", "cms_width", "topk_slots",
                  "entropy_buckets", "conntrack_slots", "identity_slots",
                  "invertible_width", "invertible_hi_width"):
            v = getattr(self, f)
            if v <= 0 or (v & (v - 1)):
                raise ValueError(f"{f} must be a positive power of two, got {v}")
        if self.heavy_keys_source not in ("flowdict", "invertible", "both"):
            raise ValueError(
                "heavy_keys_source must be 'flowdict', 'invertible' or "
                f"'both', got {self.heavy_keys_source!r}"
            )
        if self.heavy_keys_source == "both" and not (
            self.transfer_packed and self.wire_flow_dict
        ):
            raise ValueError(
                "heavy_keys_source='both' validates the invertible decode "
                "against the flow dict, which requires transfer_packed "
                "and wire_flow_dict"
            )
        if self.invertible_depth < 1:
            raise ValueError(
                f"invertible_depth must be >= 1, got {self.invertible_depth}"
            )
        if self.invertible_min_weight < 0:
            raise ValueError(
                f"invertible_min_weight must be >= 0, "
                f"got {self.invertible_min_weight}"
            )
        for f in ("watchdog_deadline_s", "watchdog_interval_s", "harvest_timeout_s",
                  "restart_backoff_base_s", "restart_backoff_max_s", "restart_window_s",
                  "circuit_half_open_s"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be > 0, got {getattr(self, f)}")
        if self.restart_max_failures < 1:
            raise ValueError(
                f"restart_max_failures must be >= 1, got {self.restart_max_failures}")
        if self.restart_backoff_jitter < 0:
            raise ValueError(
                f"restart_backoff_jitter must be >= 0, got {self.restart_backoff_jitter}")
        # The fault grammar at config load, not mid-flight in a hook (the
        # pattern of faults._ENTRY).
        for raw in self.fault_spec.split(","):
            raw = raw.strip()
            if raw and not re.match(
                r"^[\w.\-]+:(raise|corrupt|hang(\d+(\.\d+)?)?"
                r"|press(\d+(\.\d+)?)?)(@\d+)?$",
                raw,
            ):
                raise ValueError(f"bad fault_spec entry {raw!r}")
        if self.overload_sample_k < 1:
            raise ValueError(f"overload_sample_k must be >= 1, got {self.overload_sample_k}")
        if self.overload_exempt_packets < 0:
            raise ValueError(
                f"overload_exempt_packets must be >= 0, got {self.overload_exempt_packets}")
        thresholds = (
            self.overload_exit_pressure, self.overload_enter_pressure,
            self.overload_shed_pressure, self.overload_degrade_pressure,
        )
        if not all(0.0 < t <= 1.0 for t in thresholds) or any(
            a >= b for a, b in zip(thresholds, thresholds[1:])
        ):
            raise ValueError(
                "overload thresholds must satisfy 0 < exit < enter < "
                f"shed < degrade <= 1, got {thresholds}"
            )
        for f in ("overload_tick_s", "overload_dwell_s", "overload_shed_escalate_s"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be > 0, got {getattr(self, f)}")
        from retina_tpu_torch.runtime.overload import validate_shed_order

        validate_shed_order(self.overload_shed_order)
        for f in ("overload_priority_ip_mask", "overload_priority_ip_match"):
            v = getattr(self, f)
            if not (0 <= v <= 0xFFFFFFFF):
                raise ValueError(f"{f} must fit in u32, got {v}")
        if self.fleet_straggler_timeout_s <= 0:
            raise ValueError(
                f"fleet_straggler_timeout_s must be > 0, "
                f"got {self.fleet_straggler_timeout_s}"
            )
        for f in ("fleet_epoch_history", "fleet_ship_queue", "fleet_shed_ship_every",
                  "fleet_topk_k", "fleet_service_top", "fleet_tenant_series_max",
                  "timetravel_ring_windows", "timetravel_query_topk"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1, got {getattr(self, f)}")
        for f in ("fleet_expected_nodes", "fleet_max_tenants", "fleet_seed_generation",
                  "fleet_ship_spool"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0, got {getattr(self, f)}")
        if self.fleet_ship_backoff_base_s <= 0:
            raise ValueError(
                f"fleet_ship_backoff_base_s must be > 0, "
                f"got {self.fleet_ship_backoff_base_s}"
            )
        if self.fleet_ship_backoff_max_s < self.fleet_ship_backoff_base_s:
            raise ValueError(
                "fleet_ship_backoff_max_s must be >= "
                f"fleet_ship_backoff_base_s, got "
                f"{self.fleet_ship_backoff_max_s}"
            )
        for f in ("fleetquery_fanout", "fleetquery_topk"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1, got {getattr(self, f)}")
        if self.fleetquery_node_deadline_s <= 0:
            raise ValueError(
                f"fleetquery_node_deadline_s must be > 0, "
                f"got {self.fleetquery_node_deadline_s}"
            )
        for f in ("autocapture_max_sources", "autocapture_max_size_mb",
                  "detector_min_windows"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1, got {getattr(self, f)}")
        for f in ("autocapture_cooldown_s", "autocapture_lookback_windows",
                  "autocapture_lookahead_windows", "detector_cooldown_s",
                  "timetravel_query_cache_ttl_s", "fleetquery_hedge_delay_s",
                  "fleetquery_cache_ttl_s"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0, got {getattr(self, f)}")
        for f in ("trace_sample_every", "trace_ring_spans"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1, got {getattr(self, f)}")
        # The legal presets are the generator's own table (a local import:
        # the generator pulls numpy, which a bare Config() must not).
        from retina_tpu_torch.events.synthetic import PRESETS as _gen_presets

        if self.gen_preset not in _gen_presets:
            raise ValueError(
                f"gen_preset must be one of {sorted(_gen_presets)}, "
                f"got {self.gen_preset!r}"
            )
        if self.device_platform not in DEVICE_PLATFORMS:
            raise ValueError(
                f"device_platform must be one of {list(DEVICE_PLATFORMS)}, "
                f"got {self.device_platform!r}"
            )
        if self.detector_z_thresh <= 0:
            raise ValueError(f"detector_z_thresh must be > 0, got {self.detector_z_thresh}")
        if self.autocapture_duration_s <= 0:
            raise ValueError(
                f"autocapture_duration_s must be > 0, got {self.autocapture_duration_s}")


_BOOL_TRUE = {"1", "true", "yes", "on"}


def _coerce(value: str, target_type: Any) -> Any:
    if target_type is bool:
        return value.strip().lower() in _BOOL_TRUE
    if target_type is int:
        return int(value, 0)
    if target_type is float:
        return float(value)
    if target_type is list or target_type == list[str]:
        return [p.strip() for p in value.split(",") if p.strip()]
    return value


# YAML keys accepted in camelCase (reference configmap style) or snake_case.
def _normalize_key(key: str) -> str:
    out = []
    for ch in key:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out).lstrip("_")


_ALIASES = {
    "enabled_plugin": "enabled_plugins",
    "enabled_plugin_linux": "enabled_plugins",
    "metrics_interval_duration": "metrics_interval_s",
    "telemetry_interval": "telemetry_interval_s",
}


def load_config(
    path: str | None = None,
    overrides: dict[str, Any] | None = None,
    env: dict[str, str] | None = None,
) -> Config:
    """YAML file ← RETINA_* env ← explicit overrides (later wins)."""
    cfg = Config()
    fields = {f.name: f for f in dataclasses.fields(Config)}

    def apply(key: str, raw: Any, from_env: bool) -> None:
        key = _ALIASES.get(_normalize_key(key), _normalize_key(key))
        if key not in fields:
            return  # unknown keys ignored, like viper
        f = fields[key]
        ftype = f.type if not isinstance(f.type, str) else {
            "str": str, "int": int, "float": float, "bool": bool,
            "list[str]": list,
        }.get(f.type, str)
        if from_env or isinstance(raw, str) and ftype is not str:
            raw = _coerce(str(raw), ftype)
        setattr(cfg, key, raw)

    if path:
        import yaml  # only here: a config file is the one YAML the agent reads

        with open(path) as fh:
            doc = yaml.safe_load(fh) or {}
        if not isinstance(doc, dict):
            raise ValueError(f"config file {path} must be a YAML mapping")
        for k, v in doc.items():
            apply(k, v, from_env=False)

    env = dict(os.environ if env is None else env)
    for k, v in env.items():
        if k.startswith("RETINA_"):
            apply(k[len("RETINA_"):].lower(), v, from_env=True)

    for k, v in (overrides or {}).items():
        apply(k, v, from_env=False)

    cfg.validate()
    return cfg
