"""Fault tolerance: straggler telemetry (``fault.StepMonitor``)."""
