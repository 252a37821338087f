"""Serving: the autoregressive decode engine and server."""
