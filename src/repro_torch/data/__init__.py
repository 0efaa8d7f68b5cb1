"""Deterministic synthetic data of the port: the LM stream and the
frontend inputs (``pipeline``)."""
