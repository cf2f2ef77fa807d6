"""Deterministic synthetic corpora (numpy, seeded)."""
