"""Traffic drivers: each traffic mix names the driver that runs it."""
