"""Packet capture of the closed detection loop (port of part of
retina_tpu/capture/): the job descriptor and filter synthesis
(``translator.py``), the host-path output (``outputs.py``), the replay
provider over a record source (``providers.py``) and the node-side job
runner (``manager.py``). The CRD translation, the tcpdump, netsh and
socket providers and the blob and S3 outputs are not ported yet."""
