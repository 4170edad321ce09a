"""The fleet rollup tier: the RFLT wire codec (``codec.py``, with its own
MessagePack subset, ``_msgpack.py``), window epochs (``shipper.py``) and the
operator's aggregator, which merges every node's window per epoch on the
card (``aggregator.py``)."""
