"""Serve-layer store routing: one id namespace over sharded + local stores.

An :class:`AnalyticsFrontend` takes *one* ``store``; a deployment that
shards its biggest fields over the device mesh (``repro_torch.shard``) while
keeping small fields on the default single-device store needs both behind
one handle.  A :class:`StoreRouter` is that handle: it duck-types the store
surface the query/serve stack consumes and routes every call by **field-id
membership** — an id registered in the sharded store is served there,
everything else falls through to the local store — so
``AnalyticsRequest`` / ``AppendRequest`` by id hit the sharded store
transparently, with no request-level opt-in.

Rejection stays per-request: an id unknown to *both* stores raises the
standard ``KeyError`` (listing both registries), which the frontend turns
into that one request's structured error — the group and the program
caches of every other request are untouched.
"""
from __future__ import annotations

from ..store import StoreStats


class StoreRouter:
    """Route the duck-typed store surface by field-id membership.

    ``sharded`` is a :class:`repro_torch.shard.ShardedFieldStore`; ``local``
    is any single-device store (:class:`repro_torch.store.FieldStore` /
    :class:`repro_torch.stream.StreamFieldStore`) or ``None`` for a
    sharded-only deployment.  Registration stays explicit — ``put`` /
    ``put_temporal`` go to the local store, ``sharded.put`` to the mesh —
    the router only unifies the *serving* surface.
    """

    def __init__(self, sharded, local=None):
        self.sharded = sharded
        self.local = local

    def _of(self, field_id: str):
        if field_id in self.sharded:
            return self.sharded
        if self.local is not None and field_id in self.local:
            return self.local
        known = sorted(set(self.sharded.ids())
                       | set(self.local.ids() if self.local else ()))
        raise KeyError(
            f"unknown field id {field_id!r}; registered ids: "
            f"{known or '(none)'}")

    # -- registry (explicit placement) --------------------------------------
    def put(self, field_id: str, field, *, replace: bool = False) -> str:
        if self.local is None:
            raise ValueError(
                "router has no local store; register sharded fields via "
                "router.sharded.put(...)")
        if field_id in self.sharded and not replace:
            raise ValueError(
                f"field id {field_id!r} already registered "
                "(pass replace=True to overwrite)")
        return self.local.put(field_id, field, replace=replace)

    def put_temporal(self, field_id: str, tf, *, replace: bool = False) -> str:
        if self.local is None or not hasattr(self.local, "put_temporal"):
            return self.sharded.put_temporal(field_id, tf, replace=replace)
        return self.local.put_temporal(field_id, tf, replace=replace)

    def get(self, field_id: str):
        return self._of(field_id).get(field_id)

    def __contains__(self, field_id: str) -> bool:
        return (field_id in self.sharded
                or (self.local is not None and field_id in self.local))

    def ids(self) -> tuple[str, ...]:
        return tuple(self.sharded.ids()) + tuple(
            self.local.ids() if self.local else ())

    # -- serving surface ------------------------------------------------------
    def seed(self, field_id: str, stage, *, region=None, closure="cover"):
        return self._of(field_id).seed(field_id, stage, region=region,
                                       closure=closure)

    def ensure(self, field_id: str, stage, *, region=None, closure="cover"):
        return self._of(field_id).ensure(field_id, stage, region=region,
                                         closure=closure)

    def lookup(self, field_id: str, stage, *, region=None, closure="cover"):
        return self._of(field_id).lookup(field_id, stage, region=region,
                                         closure=closure)

    def is_resident(self, field_id: str, stage, *, region=None,
                    closure="cover") -> bool:
        return self._of(field_id).is_resident(field_id, stage, region=region,
                                              closure=closure)

    def cached_stages(self, field_ids, ops, *, region=None, axis: int = 0):
        fids = [field_ids] if isinstance(field_ids, str) else list(field_ids)
        stores = {id(self._of(f)) for f in fids}
        if len(stores) > 1:
            raise ValueError(
                "vector components must live in one store (sharded or "
                f"local), got a mix for {fids}")
        return self._of(fids[0]).cached_stages(field_ids, ops, region=region,
                                               axis=axis)

    def placement_of(self, field_id: str):
        store = self._of(field_id)
        placement_of = getattr(store, "placement_of", None)
        return placement_of(field_id) if placement_of is not None else None

    def temporal_summary(self, field_id: str, *, region=None, stage=None):
        store = self._of(field_id)
        if not hasattr(store, "temporal_summary"):
            raise TypeError(
                f"field id {field_id!r} lives in a store without temporal "
                "support")
        return store.temporal_summary(field_id, region=region, stage=stage)

    def is_temporal(self, field_id: str) -> bool:
        store = self._of(field_id)
        return (hasattr(store, "is_temporal")
                and store.is_temporal(field_id))

    def append(self, field_id: str, data) -> int:
        store = self._of(field_id)
        if not hasattr(store, "append"):
            raise TypeError(
                f"field id {field_id!r} lives in a store without streaming "
                "support")
        return store.append(field_id, data)

    # -- accounting -----------------------------------------------------------
    @property
    def stats(self) -> StoreStats:
        agg = StoreStats()
        for s in (self.sharded, self.local):
            if s is None:
                continue
            st = s.stats
            agg.hits += st.hits
            agg.misses += st.misses
            agg.evictions += st.evictions
            agg.rejected += st.rejected
        return agg
