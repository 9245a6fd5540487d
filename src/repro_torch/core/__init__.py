"""Slab aggregation, K(t) schedules and the parameter-server simulator."""
