"""Range queries over windowed sketch history: the snapshot ring
(``ring.py``), the fold over its slots and the queries of a folded
snapshot (``fold.py``), and the query service (``query.py``)."""
