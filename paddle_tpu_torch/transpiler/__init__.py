"""Closed-form memory accounting."""
