"""Utilities: the metrics stream."""
