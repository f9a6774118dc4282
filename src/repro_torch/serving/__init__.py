"""Split serving, static-batch and continuous-batching (PyTorch port of
``repro.serving``)."""
from repro_torch.serving.batcher import ContinuousBatchingEngine, PagedPool
from repro_torch.serving.controller import ControllerConfig, ModeController
from repro_torch.serving.engine import GenStats, ServingEngine
from repro_torch.serving.session import Request, RequestQueue, Session

__all__ = ["ContinuousBatchingEngine", "ControllerConfig", "GenStats",
           "ModeController", "PagedPool", "Request", "RequestQueue",
           "ServingEngine", "Session"]
