"""repro_torch.fleet — central cross-run profile aggregation with auto warm-start
(counterpart of ``repro/fleet/``; nothing here imports ``torch``).

Closes the analyze→aggregate→dispatch loop *across processes*: every run's
measured :class:`~repro_torch.dispatch.profiles.ProfileStore` is Welford-merged
into a central store keyed by (git SHA, chip), and any later run on matching
code + hardware warm-starts from the freshest fleet profile instead of
re-exploring (the Adaptyst cross-run aggregation the ROADMAP called for).

* :mod:`repro_torch.fleet.store` — :class:`FleetStore`, the on-disk bucket store
  (Welford merge on push, exact → chip-only → miss pull fallback,
  staleness/retention gc, ``"mixed"`` provenance never shadows a real match);
* :mod:`repro_torch.fleet.service` — stdlib ``http.server`` daemon over one store;
* :mod:`repro_torch.fleet.client` — :class:`FleetClient` (HTTP or direct-path
  transport) and :class:`FleetPusher` (delta pushes that never double-count);
* :mod:`repro_torch.fleet.cli` — ``python -m repro_torch.fleet {serve,push,pull,ls,gc}``.

Drivers wire it end-to-end via ``--fleet <url|dir>`` on ``launch.serve`` and
the router's real replicas: pull + age-out at startup, pushes while serving
(per rotation with ``--trace-dir``; a replica when it goes idle), and a
final delta push at shutdown; ``launch.train``'s ``--fleet`` likewise.
``--tune`` on both drivers (``tune/``) sweeps into the same store, so its
design-space points ride the same pushes and pulls.
"""
from repro_torch.fleet.client import (
    FleetClient,
    FleetError,
    FleetPusher,
    warm_start_from_fleet,
)
from repro_torch.fleet.service import FleetServer, make_server
from repro_torch.fleet.store import FLEET_SCHEMA, FleetStore, declared_stamp

__all__ = [
    "FLEET_SCHEMA",
    "FleetClient",
    "FleetError",
    "FleetPusher",
    "FleetServer",
    "FleetStore",
    "declared_stamp",
    "make_server",
    "warm_start_from_fleet",
]
