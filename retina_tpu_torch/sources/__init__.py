"""Event sources (port of part of retina_tpu/sources/): pcap synthesis and
the numpy pcap reader (``pcapdecode.py``)."""
