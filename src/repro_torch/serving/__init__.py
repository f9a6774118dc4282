"""Split serving, static-batch, continuous-batching and scale-out (PyTorch
port of ``repro.serving``).

``engine.ServingEngine``      — synchronous single-batch engine.
``batcher.ContinuousBatchingEngine`` — slot-pooled continuous batching with
                                per-request channels and per-slot
                                bottleneck modes; a ``PagedPool`` on
                                full-attention archs, the dense
                                ``SlotPool`` otherwise.
``controller``                — ``ModeController`` (per-slot, per-tick mode
                                re-selection) and ``Autoscaler`` (replica
                                elasticity).
``cluster.EdgeCluster``       — N engine replicas (one per simulated cell)
                                behind a router, with handover policies,
                                SLO admission and autoscaling.
``fleet``                     — fleet-scale load generation over
                                ``FleetChannel`` lanes and the predictive
                                SLO admission gate.
``migration``                 — live session migration: slot-row or
                                allocated-page snapshots, optional wire
                                quantization, bit-exact injection.
``graphs``                    — ``StepGraphs``: the engines' decode window and
                                token step as CUDA graphs (the reference's
                                ``jax.jit`` / ``lax.scan``).
``session``                   — request/queue/session lifecycle records.
``telemetry``                 — metrics registry, Chrome-trace timeline,
                                the serving clock, bench timing helpers and
                                ``torch.profiler`` capture.
"""
from repro_torch.serving.batcher import (ContinuousBatchingEngine,  # noqa: F401
                                         PagedPool, SlotPool)
from repro_torch.serving.cluster import (HANDOVER_POLICIES,  # noqa: F401
                                         PLACEMENTS, EdgeCluster,
                                         default_orchestrator)
from repro_torch.serving.controller import (Autoscaler,  # noqa: F401
                                            AutoscalerConfig,
                                            ControllerConfig,
                                            ModeController, SlotControl)
from repro_torch.serving.engine import GenStats, ServingEngine  # noqa: F401
from repro_torch.serving.fleet import (FleetLoadConfig,  # noqa: F401
                                       SLOAdmission, SLOAdmissionConfig,
                                       arrival_ticks, fleet_requests)
from repro_torch.serving.migration import (MigrationSnapshot,  # noqa: F401
                                           detach_session, extract_session,
                                           inject_session)
from repro_torch.serving.session import (Request, RequestQueue,  # noqa: F401
                                         Session)
from repro_torch.serving.telemetry import (MetricsRegistry,  # noqa: F401
                                           Telemetry, TraceRecorder,
                                           profile_capture)
