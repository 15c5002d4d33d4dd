"""Batched serving engine: continuous-batching-lite over fixed decode slots.

A fixed-capacity slot array with per-slot activity: requests join free
slots (their prompt is fed into the shared cache), every engine ``step()``
decodes one token for all active slots, finished slots are recycled.
Greedy sampling.  The KV cache can hold HSZ stage-③ int8 residency
(``kv_quant`` in the arch config).

The slot semantics are the reference's, kept as they are: one position
counter is shared by all slots (every decode step advances it, a prompt
token fed for one slot included), and a new request's prompt tokens but the
last go through single-slot steps on admission, the last one on the next
``step()``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from ..models import Model


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 16
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, model: Model, params, *, slots: int = 4,
                 max_len: int = 512, eos_id: int | None = None,
                 device="cuda"):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = kernel_ops.resolve_device(device)
        self.cache = model.init_cache(slots, max_len, device=self.device)
        self.active: list[Request | None] = [None] * slots
        self.slot_pos = np.zeros(slots, np.int32)
        self._decode = model.decode_step
        self._queue: list[Request] = []

    # -- request lifecycle ---------------------------------------------------
    def add_request(self, req: Request):
        self._queue.append(req)

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is None and self._queue:
                req = self._queue.pop(0)
                self.active[s] = req
                # teacher-forced prefill: feed prompt tokens one by one into
                # the shared cache (simple and exact; a chunked prefill path
                # exists for long prompts via model.prefill)
                for t in req.prompt[:-1]:
                    self._step_single_slot(s, int(t))
                self._last_token_for_slot(s, int(req.prompt[-1]))

    def _last_token_for_slot(self, slot, token):
        self.slot_pos[slot] = token

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(toks, device=self.device)

    def _step_single_slot(self, slot, token):
        # feed `token` through the decode step for cache side effects;
        # other slots receive pad token 0 and their caches also advance, so
        # positions are kept per-engine-step (single shared pos counter).
        toks = np.zeros((self.slots, 1), np.int32)
        toks[slot, 0] = token
        _, self.cache = self._decode(self.params, self._tokens(toks), self.cache)

    # -- decode loop -----------------------------------------------------------
    def step(self) -> dict[int, int]:
        """One decode step for all active slots; returns {uid: token}."""
        self._admit()
        toks = np.zeros((self.slots, 1), np.int32)
        for s, req in enumerate(self.active):
            if req is not None:
                toks[s, 0] = self.slot_pos[s]
        logits, self.cache = self._decode(self.params, self._tokens(toks),
                                          self.cache)
        next_tokens = torch.argmax(logits[:, -1, :], dim=-1).to(
            torch.int32).cpu().numpy()
        emitted = {}
        for s, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(next_tokens[s])
            req.out_tokens.append(tok)
            emitted[req.uid] = tok
            self.slot_pos[s] = tok
            if (self.eos_id is not None and tok == self.eos_id) or \
                    len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                self.active[s] = None
        return emitted

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        seen: dict[int, Request] = {}
        steps = 0
        while (self._queue or any(self.active)) and steps < max_steps:
            for r in self.active:
                if r is not None:
                    seen[r.uid] = r
            self.step()
            steps += 1
        return [r for r in seen.values() if r.done]
