"""Batched serving engine with continuous batching over the decode step
(the port of the JAX package's ``serve/engine.py``).

  * a fixed pool of B cache slots (one batch row each);
  * requests queue up; free slots are filled as soon as they open
    (continuous batching — no waiting for the whole batch to finish);
  * per-slot positions: each slot decodes at its own offset, so
    mixed-length requests share one batch (the attention mask comes from
    each row's length, ``kv_len = pos + 1``);
  * prefill is token by token through the same step;
  * greedy argmax; a request ends at ``max_new_tokens``, at its ``eos_id``,
    or when its slot reaches ``max_seq - 1``.

The reference vmaps a B = 1 decode over the slots; here the model's
``decode_step`` takes a (B,) position vector and runs them as one batch,
with ``rows_apart``: a moe model routes each slot as its own dispatch group,
so expert capacity never couples two slots (or a slot and an idle one), as
under the reference's vmap.
One difference, on purpose: when a request takes a slot the engine zeroes
that slot's recurrent state (``model.reset_slot``: the mamba conv window
and SSD state).  The reference resets only the slot's position, so a
mamba request in a reused slot starts from its predecessor's state; an
attention cache needs no reset, since rows past the position are masked.
The engine serves every family that decodes (the audio family is
encoder-only: its ``init_cache`` raises).  A vlm's image K/V stay
``init_cache``'s zeros, as in the reference's engine, so its tokens are
text-only: the cross blocks attend over zero keys and values.

The engine runs on the model's device; the model holds its parameters.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.launch.steps import make_serve_step


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    # filled by the engine:
    output: list[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    finished_at: float = 0.0
    slot: int = -1           # the slot it was served in
    reused_slot: bool = False  # that slot had served an earlier request

    @property
    def done(self) -> bool:
        return self.finished_at > 0


class ServeEngine:
    """Continuous-batching scheduler around the model's decode step.

    Every tick decodes all B slots; idle slots carry a pad token at position
    0 and their outputs are discarded.  ``tick_seconds`` holds each tick's
    host time; a tick ends by reading the argmax back to the host, so on the
    card it is synchronised.
    """

    def __init__(self, model, *, slots: int = 4, max_seq: int = 256, pad_id: int = 0):
        self.model = model
        self.device = model.device
        self.B = slots
        self.max_seq = max_seq
        self.pad_id = pad_id
        self.cache = model.init_cache(batch=slots, max_seq=max_seq, dtype=torch.float32)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.slot_pos = np.zeros(slots, np.int64)       # next position to write
        self.slot_phase = ["idle"] * slots              # idle | prefill | decode
        self.slot_used = [False] * slots
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.tick_seconds: list[float] = []
        self._uid = 0
        self._step = make_serve_step(model, rows_apart=True)

    # ------------------------------------------------------------ API

    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> Request:
        self._uid += 1
        req = Request(uid=self._uid, prompt=list(prompt), max_new_tokens=max_new_tokens,
                      eos_id=eos_id, submitted_at=time.time())
        self.queue.append(req)
        return req

    def run(self, max_ticks: int = 10_000) -> list[Request]:
        """Drive until queue + slots drain (or tick budget)."""
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self._fill_slots()
            t0 = time.perf_counter()
            self._tick()
            self.tick_seconds.append(time.perf_counter() - t0)
        return self.finished

    # ------------------------------------------------------------ internals

    def _fill_slots(self):
        for s in range(self.B):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.popleft()
                req.slot, req.reused_slot = s, self.slot_used[s]
                self.slot_req[s] = req
                self.slot_pos[s] = 0
                self.slot_phase[s] = "prefill"
                self.slot_used[s] = True
                self.model.reset_slot(self.cache, s)

    def _tick(self):
        tokens = np.full((self.B, 1), self.pad_id, np.int64)
        pos = np.zeros(self.B, np.int64)
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            p = int(self.slot_pos[s])
            tokens[s, 0] = req.prompt[p] if self.slot_phase[s] == "prefill" else req.output[-1]
            pos[s] = p

        logits, self.cache = self._step(self.cache, torch.from_numpy(tokens).to(self.device),
                                        torch.from_numpy(pos).to(self.device))
        next_tok = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()

        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.slot_pos[s] += 1
            p = int(self.slot_pos[s])
            if self.slot_phase[s] == "prefill":
                if p >= len(req.prompt):
                    self.slot_phase[s] = "decode"
                    req.output.append(int(next_tok[s]))
            else:
                req.output.append(int(next_tok[s]))
            out_done = len(req.output) >= req.max_new_tokens
            eos_done = req.eos_id is not None and req.output and req.output[-1] == req.eos_id
            if self.slot_phase[s] == "decode" and (out_done or eos_done or p >= self.max_seq - 1):
                req.finished_at = time.time()
                self.finished.append(req)
                self.slot_req[s] = None
                self.slot_phase[s] = "idle"


@torch.no_grad()
def greedy_decode(model, prompt: list[int], n_new: int, max_seq: int, *,
                  batch: int = 1, row: int = 0) -> list[int]:
    """Direct greedy decode of one request, token by token through the
    decode step, with no scheduler: the request in row ``row`` of a fresh
    ``batch``-row cache, the other rows idle (pad token 0 at position 0, as
    the engine's idle slots; a moe model routes each row alone, as the
    engine does).  ``batch=1`` is the single-request decode."""
    step = make_serve_step(model, rows_apart=True)
    cache = model.init_cache(batch=batch, max_seq=max_seq, dtype=torch.float32)
    tokens = torch.zeros((batch, 1), dtype=torch.int64, device=model.device)
    pos = torch.zeros(batch, dtype=torch.int64, device=model.device)
    out, logits = [], None
    seq = list(prompt)
    for i in range(len(prompt) + n_new - 1):
        tokens[row, 0], pos[row] = seq[i], i
        logits, cache = step(cache, tokens, pos)
        if i >= len(prompt) - 1:
            seq.append(int(torch.argmax(logits[row, -1])))
            out.append(seq[-1])
    return out[:n_new]
