"""Deterministic frontend inputs of the port (``pipeline``)."""
