"""Metrics primitives."""
