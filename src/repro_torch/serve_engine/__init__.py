"""Power-budget-aware multi-operating-point serving (port of
``repro.serve_engine``): the rung ladder, the continuous-batching
scheduler, ``ServeEngine`` (decode), ``EncodeEngine`` (whole-sequence
encode waves under per-item budgets), the v1 serving artifact, and
``Fleet``: simulated hosts serving one device store under one global
power cap (prefill/decode disaggregation, rung-sharded decode hosts, a
telemetry-driven governor, host restarts by prefix replay)."""
from repro_torch.serve_engine.artifact import (ArtifactError, load_artifact,
                                               write_artifact)
from repro_torch.serve_engine.encoder import (EncodeEngine, EncodeRequest,
                                              EncodeResponse)
from repro_torch.serve_engine.engine import Lane, ServeEngine
from repro_torch.serve_engine.fleet import (Fleet, FleetConfig, FleetTrace,
                                            PowerGovernor, TrafficSpec,
                                            make_trace, verify_streams)
from repro_torch.serve_engine.ladder import (OperatingPoint, build_ladder,
                                             select_rung)
from repro_torch.serve_engine.scheduler import (Request, Response,
                                                Scheduler)

__all__ = ["ServeEngine", "Lane", "OperatingPoint", "build_ladder",
           "select_rung", "Request", "Response", "Scheduler",
           "EncodeEngine", "EncodeRequest", "EncodeResponse",
           "ArtifactError", "load_artifact", "write_artifact",
           "Fleet", "FleetConfig", "FleetTrace", "PowerGovernor",
           "TrafficSpec", "make_trace", "verify_streams"]
