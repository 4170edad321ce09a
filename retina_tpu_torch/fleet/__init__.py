"""The fleet rollup tier: the RFLT wire codec (``codec.py``, with its own
MessagePack subset, ``utils/_msgpack.py``), the node's shipper (``shipper.py``:
each window close's export over the in-process bus or the relay's
``retina.Fleet/Ship`` client), the operator's aggregator, which merges every
node's window per epoch on the card and publishes the ``fleet_*`` series
(``aggregator.py``), and the multi-agent dryruns (``dryrun.py``)."""
