"""Serving: batched token generation, batched homomorphic analytics and
streaming temporal ingest.

:class:`Engine` decodes :class:`Request` token streams over fixed slots;
:class:`AnalyticsFrontend` queues :class:`AnalyticsRequest` and
:class:`AppendRequest` and serves each step's groups with one engine
dispatch each; :class:`StoreRouter` puts a sharded store
(``repro_torch.shard``) and a single-device store behind one id namespace.
"""
from .engine import Engine, Request
from .analytics import AnalyticsFrontend, AnalyticsRequest, AppendRequest
from .routing import StoreRouter

__all__ = ["Engine", "Request", "AnalyticsFrontend", "AnalyticsRequest",
           "AppendRequest", "StoreRouter"]
