"""The port's trace plane (counterpart of ``repro/trace/``): the bounded
collector (``collector``), sessions and their diffs (``session``), the
exporters (``export``), durable segment streams (``stream``), the Kineto
adapter (``device``), live ``torch.profiler`` windows (``liveprof``),
cross-process stitching of a router's and its replicas' sessions
(``stitch``) and the CLI (``cli``, ``python -m repro_torch.trace``).  Submodules are imported by
name: ``serving/compiled.py`` and ``dispatch/dispatcher.py`` import
``liveprof``, and a package that imported ``session`` here would cycle back
through ``dispatch``."""
