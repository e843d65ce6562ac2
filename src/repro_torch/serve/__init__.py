"""The port's serving fabric (``repro.serve`` on one GPU): the
multi-tenant ``ComposedServer`` with its analytical policy, the serving
DSE's Stage 1, replica groups and open-loop traffic.  The encoder and
enc-dec engines, and the reference's ``serve_engine_rules`` (tensor
parallelism over a mesh), are not part of the port yet."""
from repro_torch.core.dse import DesignPoint
from repro_torch.obs import (MetricsRegistry, PredictionLedger, SpanTracer,
                             Telemetry)
from repro_torch.serve.dse import (Stage1Optimizer, TenantDesignSpace,
                                   design_key)
from repro_torch.serve.fabric import (AnalyticalPolicy, ComposedServer,
                                      RecompositionEvent, ReplicaGroup,
                                      SLOTarget, TenantLoad,
                                      TenantObservation, TenantSpec)
from repro_torch.serve.traffic import PROFILES, Arrival, arrival_schedule
from repro_torch.workloads import DecodeEngine, Request, ServeConfig, SSMEngine
from repro_torch.workloads.compile_cache import ExecutableCache

# the serving engine is the transformer decode workload class; the name
# stays public as in the reference
ServeEngine = DecodeEngine

__all__ = [
    "ExecutableCache",
    "Request",
    "ServeConfig",
    "ServeEngine",
    "DecodeEngine",
    "SSMEngine",
    "AnalyticalPolicy",
    "Arrival",
    "ComposedServer",
    "PROFILES",
    "SLOTarget",
    "arrival_schedule",
    "DesignPoint",
    "MetricsRegistry",
    "PredictionLedger",
    "RecompositionEvent",
    "ReplicaGroup",
    "SpanTracer",
    "Stage1Optimizer",
    "Telemetry",
    "design_key",
    "TenantDesignSpace",
    "TenantLoad",
    "TenantObservation",
    "TenantSpec",
]
