"""Serving runtime: the continuous-batching engine."""
