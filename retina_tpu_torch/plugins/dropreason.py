"""Drop reasons (port of the ``DROP_REASONS`` table of
retina_tpu/plugins/dropreason.py; the plugin itself is not ported yet).

Reason ids 1..7 of the synthetic and pcap sources map to the reference's
drop reasons; 8..13 carry Cilium dataplane reasons folded into named
buckets (the reason axis is a 16-wide rectangle).
"""

DROP_REASONS = {
    0: "unknown",
    1: "iptable_rule_drop",
    2: "iptable_nat_drop",
    3: "tcp_connect_basic",
    4: "tcp_accept_basic",
    5: "conntrack_add_drop",
    6: "softnet_drop",
    7: "listen_overflow",
    8: "policy_denied",
    9: "invalid_packet",
    10: "invalid_source_ip",
    11: "conntrack_invalid",
    12: "unsupported_proto",
    13: "cilium_other",
}
