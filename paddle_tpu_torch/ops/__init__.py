"""Ops of the decode path."""
