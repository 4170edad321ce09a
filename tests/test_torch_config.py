"""The port's layered configuration and ``cli config`` against the reference.

``load_config`` of both packages reads the same YAML file (camelCase keys,
the reference's aliases, a key only the reference knows and one neither
knows), the same ``RETINA_*`` environment (bool, int, float and list
coercion) and the same overrides; every field the two ``Config`` classes
share must come out equal, and a bad value must raise the same ``validate``
error. ``cli config`` prints the effective configuration as YAML; its
shared fields must equal the reference CLI's.
"""

from __future__ import annotations

import dataclasses

import pytest
import yaml

import retina_tpu.cli as ref_cli
import retina_tpu.config as ref_config
import retina_tpu_torch.cli as port_cli
import retina_tpu_torch.config as port_config

YAML_DOC = """\
apiServerAddr: 0.0.0.0:10094
enabledPlugin: [packetparser, dns]
metricsIntervalDuration: 5
telemetryInterval: 60
batchCapacity: 2048
enablePodLevel: false
dataAggregationLevel: high
eventSource: pcap
pcapPath: /var/run/capture.pcap
pcapLoop: false
synthetic_rate: "2e5"
windowSeconds: 0.5
timetravelEnabled: true
detectorsEnabled: true
compilationCacheDir: /var/cache/xla
notAConfigKey: 7
"""

ENV = {
    "RETINA_ENABLE_TELEMETRY": "yes",
    "RETINA_N_PODS": "0x100",
    "RETINA_SYNTHETIC_FLOWS": "5000",
    "RETINA_FLUSH_INTERVAL_S": "0.025",
    "RETINA_ENABLED_PLUGINS": "dropreason, packetparser,dns",
    "RETINA_GEN_PRESET": "zipf",
    "RETINA_OVERLOAD_SHED_ORDER": "conntrack,dns",
    "RETINA_LOG_LEVEL": "debug",
    "RETINA_DISTRIBUTED_NUM_PROCESSES": "4",
    "UNRELATED": "1",
}

OVERRIDES = {"snapshot_interval_s": "2.5", "autocapture_enabled": "true",
             "capture_iface": "eth1", "fault_spec": "transfer:raise@3"}


def _shared(a, b) -> list[str]:
    return sorted({f.name for f in dataclasses.fields(a)} & {f.name for f in dataclasses.fields(b)})


def _assert_shared_equal(ref, port) -> None:
    names = _shared(ref, port)
    assert len(names) == len(dataclasses.fields(port))  # every port field is the reference's
    diff = {n: (getattr(ref, n), getattr(port, n)) for n in names
            if getattr(ref, n) != getattr(port, n)}
    assert not diff


def test_defaults_equal_the_reference_on_every_shared_field():
    _assert_shared_equal(ref_config.Config(), port_config.Config())
    assert port_config.DEFAULT_PLUGINS == ref_config.DEFAULT_PLUGINS


@pytest.mark.parametrize("layers", ["yaml", "env", "overrides", "all"])
def test_load_config_layers_equal_the_reference(tmp_path, layers):
    path = None
    if layers in ("yaml", "all"):
        path = tmp_path / "retina.yaml"
        path.write_text(YAML_DOC)
        path = str(path)
    env = ENV if layers in ("env", "all") else {}
    ov = OVERRIDES if layers in ("overrides", "all") else None
    ref = ref_config.load_config(path, overrides=ov, env=env)
    port = port_config.load_config(path, overrides=ov, env=env)
    _assert_shared_equal(ref, port)
    if layers == "all":
        # env wins over the file, overrides over both; each type coerced
        assert port.enabled_plugins == ["dropreason", "packetparser", "dns"]
        assert port.n_pods == 256 and port.enable_telemetry is True
        assert port.flush_interval_s == 0.025 and port.synthetic_rate == 2e5
        assert port.overload_shed_order == ["conntrack", "dns"]
        assert port.snapshot_interval_s == 2.5 and port.autocapture_enabled is True
        assert port.api_server_addr == "0.0.0.0:10094" and port.pcap_loop is False


def test_load_config_reads_the_process_environment(monkeypatch):
    monkeypatch.setenv("RETINA_METRICS_INTERVAL_S", "3")
    monkeypatch.setenv("RETINA_DEVICE_PLATFORM", "cpu")
    ref, port = ref_config.load_config(), port_config.load_config()
    _assert_shared_equal(ref, port)
    assert port.device_platform == "cpu" and port.metrics_interval_s == 3.0


@pytest.mark.parametrize("bad", [
    {"batch_capacity": 1000},
    {"n_pods": 0},
    {"data_aggregation_level": "medium"},
    {"gen_preset": "bursty"},
    {"restart_max_failures": 0},
    {"watchdog_deadline_s": 0},
    {"fault_spec": "transfer:explode"},
    {"overload_exit_pressure": 0.8},
    {"overload_shed_order": "dns,bogus"},
    {"fleet_straggler_timeout_s": 0},
    {"timetravel_ring_windows": 0},
    {"autocapture_cooldown_s": -1},
    {"detector_z_thresh": 0},
    {"detector_min_windows": 0},
    {"heavy_keys_source": "sketch"},
    {"invertible_depth": 0},
    {"trace_ring_spans": 0},
    {"overload_priority_ip_mask": 1 << 32},
    {"fleet_ship_queue": 0},
    {"fleet_shed_ship_every": 0},
    {"fleet_ship_spool": -1},
    {"fleet_seed_generation": -1},
    {"fleet_ship_backoff_base_s": 0},
    {"fleet_ship_backoff_max_s": 0.01},
    {"fleetquery_fanout": 0},
    {"fleetquery_topk": 0},
    {"fleetquery_node_deadline_s": 0},
    {"fleetquery_hedge_delay_s": -1},
    {"fleetquery_cache_ttl_s": -1},
])
def test_validate_raises_the_reference_error(bad):
    with pytest.raises(ValueError) as ref_err:
        ref_config.load_config(None, overrides=bad, env={})
    with pytest.raises(ValueError) as port_err:
        port_config.load_config(None, overrides=bad, env={})
    assert str(port_err.value) == str(ref_err.value)


def test_device_platform_names_a_torch_device():
    assert port_config.load_config(None, overrides={"device_platform": "cpu"}, env={}
                                   ).device_platform == "cpu"
    with pytest.raises(ValueError, match="device_platform"):
        port_config.load_config(None, overrides={"device_platform": "tpu"}, env={})


def test_config_file_must_be_a_mapping(tmp_path):
    path = tmp_path / "list.yaml"
    path.write_text("- a\n- b\n")
    with pytest.raises(ValueError, match="YAML mapping"):
        port_config.load_config(str(path), env={})


@pytest.mark.parametrize("argv", [[], ["--set", "batch_capacity=4096", "--set",
                                       "enabled_plugins=dns,mock"]])
def test_cli_config_prints_the_reference_values(tmp_path, capsys, monkeypatch, argv):
    for k in [k for k in __import__("os").environ if k.startswith("RETINA_")]:
        monkeypatch.delenv(k)
    path = tmp_path / "retina.yaml"
    path.write_text(YAML_DOC)
    args = ["config", "--config", str(path), *argv]
    assert ref_cli.main(args) == 0
    ref = yaml.safe_load(capsys.readouterr().out)
    assert port_cli.main(args) == 0
    port = yaml.safe_load(capsys.readouterr().out)
    shared = sorted(set(ref) & set(port))
    assert shared == sorted(port)
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
