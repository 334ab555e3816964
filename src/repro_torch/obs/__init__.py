"""Observability of the port: the serial DES's event log.

Counterpart of ``repro/obs``, of which only ``events.py`` (a copy) is
here so far; the fleet telemetry, its exporters and the phase profiler
are still to port. Nothing here may import ``sim/engine.py`` back at
module scope, since the engine imports this package.
"""

from repro_torch.obs.events import KINDS, Event, EventLog

__all__ = ["Event", "EventLog", "KINDS"]
