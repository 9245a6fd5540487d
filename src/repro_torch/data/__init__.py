"""Deterministic synthetic datasets (numpy)."""
