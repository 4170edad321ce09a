"""The detector bank (port of retina_tpu/detect/).

Derived detectors over the engine's record tap, each a small program on
the card (``programs.py``: K11-K13):

- ``portscan``   HLL of distinct dst ports per source hash-group
- ``dnstunnel``  entropy over DNS qname lengths
- ``synflood``   SYN:ACK asymmetry over the tcpflag lanes

Every detector feeds the same closed loop: detect -> range-query the
snapshot ring -> invertible attribution -> targeted capture
(``timetravel/autocapture.py``), arbitrated per window by priority with a
per-detector cooldown.
"""

from retina_tpu_torch.detect.base import (  # noqa: F401
    Detection,
    Detector,
    DetectorBank,
    build_default_bank,
    register,
    registered,
)
