"""Continuous-batching split serving (PyTorch port of ``repro.serving``)."""
from repro_torch.serving.batcher import ContinuousBatchingEngine, PagedPool
from repro_torch.serving.controller import ControllerConfig, ModeController
from repro_torch.serving.session import Request, RequestQueue, Session

__all__ = ["ContinuousBatchingEngine", "ControllerConfig", "ModeController",
           "PagedPool", "Request", "RequestQueue", "Session"]
