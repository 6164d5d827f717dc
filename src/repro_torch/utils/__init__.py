"""Small host-side helpers shared by the trace and metrics planes
(counterparts of ``repro/utils/io.py`` and ``repro/utils/ready.py``)."""
