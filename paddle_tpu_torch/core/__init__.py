"""Core: places and dtypes."""
