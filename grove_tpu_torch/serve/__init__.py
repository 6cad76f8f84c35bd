"""Serving: the HTTP micro-batching server and the continuous-batching
engine."""
from .server import BatchingEngine, GroveServer, serve  # noqa: F401
from .continuous import ContinuousEngine, ContinuousService  # noqa: F401
