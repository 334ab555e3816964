"""Workload traces of the mobile-edge testbed (§V)."""
