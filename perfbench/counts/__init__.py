"""Frozen FLOP and byte counts: what the per-layer shares divide by."""
