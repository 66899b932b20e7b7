"""Serving: the batched engine (scheduler, metrics, traffic and the prefix
cache are not ported yet — ROADMAP.md, Queue A item 9)."""
from .engine import Completion, Engine, Request, cache_cat, cache_take

__all__ = ["Request", "Completion", "Engine", "cache_cat", "cache_take"]
