"""The system under test: the PyTorch port's analytics serving path.

Everything the benchmark takes from the port goes through here: the
compressor that fills the store, the ``FieldStore`` and the
``AnalyticsFrontend`` whose ``step`` the window drives, and the port's own
counters (kernel launches, the store's statistics).  Nothing else of the
benchmark imports the port.
"""
from __future__ import annotations

import dataclasses
import sys
import warnings
from pathlib import Path

import synth
from traffic import field_count

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import by_name  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.serve import AnalyticsFrontend, AnalyticsRequest  # noqa: E402
from repro_torch.store import FieldStore  # noqa: E402


def field_id(index: int) -> str:
    return f"f{index}"


class System:
    """A store of one configuration's fields behind one frontend.

    ``serve`` (the port's serving package), ``store`` and ``field_id`` are
    what a request's ``to_port`` may use."""

    serve = serve
    field_id = staticmethod(field_id)

    def __init__(self, config: dict, seed: int, device):
        self.config = config
        dims = tuple(config["dims"])
        if config["container"] != "Encoded":
            raise ValueError("the benchmark's stores hold Encoded fields")
        comp = by_name(config["scheme"], tuple(config["block"]))
        self.store = FieldStore(cache_bytes=int(config["store_bytes"]))
        #: each field's packed width: the configuration's, or the field's
        #: own where it needs more
        self.bits = []
        for i in range(field_count(config)):
            x = synth.make_field(seed, i, dims, device)
            c = comp.compress(x, rel_eb=config["rel_eb"], device=device)
            self.bits.append(max(int(config["bits"]), comp.max_bits(c)))
            self.store.put(field_id(i), comp.encode(c, bits=self.bits[-1]))
        self.frontend = AnalyticsFrontend(store=self.store)

    def submit(self, uid: int, req):
        """Enqueue one generated request (``traffic.Request``); the port's
        request is returned."""
        r = req.to_port(uid, self)
        self.frontend.add_request(r)
        return r

    def step(self) -> list:
        """One serving step: the requests it finished."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return self.frontend.step()

    def counters(self) -> dict:
        """The port's cumulative counters: launches per kernel site and the
        store's statistics (``StoreStats``)."""
        return {"launches": dict(kernel_ops.LAUNCHES),
                "store": dataclasses.asdict(self.store.stats)}


def answer_of(r: AnalyticsRequest):
    """``(value, stage)`` of a finished request: the value as the port gave
    it (a tensor, or a tuple for ``gradient``) and its stage as an int."""
    return r.result, int(r.result_stage)
