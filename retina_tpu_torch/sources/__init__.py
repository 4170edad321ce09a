"""Host-side event sources (port of retina_tpu/sources/): the pcap decoder
(``pcapdecode.py``, the native decoder first), the replay source
(``pcapreplay.py``), the ``/proc`` and ``/sys`` readers of the host-stat
plugins (``procfs.py``), and the Cilium monitor socket source
(``cilium_monitor.py`` over the gob codec ``gobcodec.py``)."""
