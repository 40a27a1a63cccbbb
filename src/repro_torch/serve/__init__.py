"""The serving plane of the port: multi-tenant composed-model inference
with continuous batching (see ``engine.ServeEngine``)."""

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.lanes import Lane
from repro_torch.serve.store import CompositionStore, TenantEntry
from repro_torch.serve.types import Completion, Request

__all__ = [
    "CompositionStore",
    "Completion",
    "Lane",
    "Request",
    "ServeEngine",
    "TenantEntry",
]
