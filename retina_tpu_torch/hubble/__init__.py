"""The relay's fleet client (``server.py``): ``FLEET_SERVICE`` and
``FleetShipClient``, which a node's shipper uses when ``fleet_relay_addr``
is set. The rest of the reference's hubble/ (the flow observer, the relay
server and its protobuf surface) waits for ROADMAP §1 item 7."""
