"""Serving runtime: the request slot map and the continuous-batching
``ServeLoop``."""
