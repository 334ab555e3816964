"""Discrete-event simulation of the mobile-edge testbed (§V)."""
