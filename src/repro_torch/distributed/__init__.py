"""Distribution layer: logical-axis sharding rules over a ``DeviceMesh``
(the counterpart of ``repro/distributed``)."""
