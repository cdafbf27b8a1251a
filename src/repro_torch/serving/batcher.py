"""Continuous batching scheduler (reactive serving layer).

Requests arrive in a mailbox; the batcher holds a fixed-slot decode batch
and, whenever a slot frees (EOS or max-new-tokens), admits the next
request from the queue.  Shapes stay static (slots, max_len): the
elasticity is in occupancy, not in tensor shapes.

Paged mode (``paged=PagedSpec(...)``) is the serving hot path: K/V live in
a shared page pool behind per-slot page tables.  A slot holds only the
pages its request fills, pages are granted one at a time as the decode
position crosses page boundaries, and a slot that cannot get its next
page is preempted: pages freed, request requeued undecoded (recompute
beats repair).  Without ``paged`` (dense mode), each slot owns its batch
row of every cache tensor: ``max_len`` rows of a linear KV cache, or a
Mamba layer's conv and SSM states.  Paged mode is attention-only.

The batcher keeps host (numpy) copies of every index the decode kernels
read: the slot positions, the page tables and the device cache
positions.  The kernel wrappers do not inspect CUDA tensors, since that
would sync once per layer per tick, so the range check happens here,
once per tick, on the host copies.  In both modes an idle slot rides
every decode tick and its cache position advances; it is reset to 0
when the slot frees and whenever it would leave the cache (the page
table row, or ``max_len`` rows of a linear cache).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.messages import Mailbox, Message
from repro_torch.models.zoo import Model
from repro_torch.serving.kv_cache import PagedSpec, PagePool
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step

_req_ids = itertools.count()


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    req_id: int = field(default_factory=lambda: next(_req_ids))
    # filled on completion; enqueued_at is stamped once, on the first
    # submission: a re-admission after preemption keeps its place.
    output: Optional[List[int]] = None
    enqueued_at: Optional[float] = None
    completed_at: float = 0.0
    restarts: int = 0  # times re-admitted after a preemption
    # Why an empty completion happened ("invalid" | "oversize"); None for
    # a normally decoded request.
    fail_reason: Optional[str] = None

    def reset_for_readmission(self) -> "Request":
        """Back to the not-yet-decoded state."""
        self.output = None
        self.completed_at = 0.0
        self.fail_reason = None
        self.restarts += 1
        return self


def _write_row(full: dict, row: dict, slot: int) -> None:
    """Copy every tensor of a one-row cache into batch row ``slot`` of the
    shared cache, in place (each cache tensor leads with the batch)."""
    for key, value in row.items():
        if isinstance(value, dict):
            _write_row(full[key], value, slot)
        else:
            full[key][slot] = value[0]


class ContinuousBatcher:
    """Runs on the model's device (``"cuda"`` unless the model was built
    with ``device="cpu"``)."""

    def __init__(
        self,
        model: Model,
        params: Any,
        slots: int = 4,
        max_len: int = 128,
        eos_token: int = -1,  # -1: run to max_new_tokens
        temperature: float = 0.0,
        paged: Optional[PagedSpec] = None,
    ) -> None:
        self.model = model
        self.params = params
        self.device = model.device
        self.slots = slots
        self.max_len = max_len
        self.eos = eos_token
        self.queue = Mailbox("serve-requests")
        self.prefill_step = make_prefill_step(model)
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self.decode_step = make_decode_step(model, temperature, self.generator)
        self.completed: List[Request] = []
        # slot state
        self.active: List[Optional[Request]] = [None] * slots
        self.positions = np.zeros((slots,), dtype=np.int32)
        self.budgets = np.zeros((slots,), dtype=np.int32)
        self.cur_tokens = np.zeros((slots, 1), dtype=np.int64)
        self.outputs: List[List[int]] = [[] for _ in range(slots)]
        # one shared cache; slot b owns batch row b.  Per-slot prefill uses
        # a single-row cache, then copies it in.
        self.paged = paged
        self.cache = model.init_cache(slots, max_len, paged=paged)
        self.page_pool: Optional[PagePool] = None
        if paged is not None:
            self.page_pool = PagePool(paged)
            # host copy of the per-slot page tables; pushed to the device
            # once per dirty tick, not once per mutation.
            self._page_table = np.zeros(
                (slots, paged.pages_per_slot(max_len)), dtype=np.int32
            )
            self._table_dirty = False
            self.slot_pages: List[List[int]] = [[] for _ in range(slots)]
        # host copy of the device cache ``pos`` (the same in every
        # attention layer): an idle slot still rides the decode step, so
        # its device position advances every tick.
        self._cache_pos = np.zeros((slots,), dtype=np.int64)
        # rows of the cache an active slot's position may index: the
        # page-table row, or the linear cache's max_len
        self._pos_cap = (paged.pages_per_slot(max_len) * paged.page_size
                         if paged is not None else max_len)
        # requests that could not be admitted for lack of pages, or were
        # preempted mid-decode, wait here ahead of the queue, sorted by
        # arrival, until a finish or preemption frees pages.
        self._stalled: List[Message] = []
        self.preemptions = 0
        self.admit_stalls = 0
        self.rejected_oversize = 0
        self.rejected_invalid = 0
        self.steps = 0

    # -- API --------------------------------------------------------------
    def submit(self, req: Request, now: float = 0.0) -> None:
        if req.enqueued_at is None:
            req.enqueued_at = now
        self.queue.put(Message(topic="serve", payload=req, created_at=now))

    def queue_depth(self) -> int:
        return self.queue.depth() + len(self._stalled)

    def occupancy(self) -> int:
        return sum(1 for r in self.active if r is not None)

    # -- internals ----------------------------------------------------------
    def _prompt(self, req: Request) -> torch.Tensor:
        return torch.tensor([req.prompt], dtype=torch.int64, device=self.device)

    def _admit(self, slot: int, req: Request) -> bool:
        """Prefill ``req`` into slot ``slot``.  Returns False when paged
        mode cannot grant the prompt's pages (caller stalls the request;
        slot state is untouched)."""
        if self.paged is not None:
            next_tok = self._prefill_paged(slot, req)
            if next_tok is None:
                return False
        else:
            row_cache = self.model.init_cache(1, self.max_len)
            next_tok, row_cache = self.prefill_step(
                self.params, {"tokens": self._prompt(req)}, row_cache
            )
            for full, row in zip(self.cache, row_cache):
                _write_row(full, row, slot)
            self._cache_pos[slot] = len(req.prompt)
        first = int(next_tok[0])
        self.active[slot] = req
        self.positions[slot] = len(req.prompt)
        self.budgets[slot] = req.max_new_tokens - 1
        self.cur_tokens[slot, 0] = first
        self.outputs[slot] = [first]
        return True

    def _prefill_paged(self, slot: int, req: Request) -> Optional[torch.Tensor]:
        """Paged admission: allocate the prompt's pages, prefill into a
        single-row scratch pool, then copy the filled pages into the
        shared pool at the granted ids.  Returns the first decoded token,
        or None when the pool cannot grant the pages right now."""
        need = self.page_pool.pages_for(len(req.prompt))
        ids = self.page_pool.alloc(need)
        if ids is None:
            return None
        # Scratch pool: page 0 reserved + exactly the prompt's pages,
        # mapped 1:1 onto temp ids 1..need.
        row_spec = PagedSpec(num_pages=need + 1, page_size=self.paged.page_size)
        row_cache = self.model.init_cache(1, self.max_len, paged=row_spec)
        tmp_table = np.zeros((1, row_spec.pages_per_slot(self.max_len)),
                             dtype=np.int32)
        tmp_table[0, :need] = np.arange(1, need + 1)
        tmp_dev = torch.tensor(tmp_table, device=self.device)
        for row in row_cache:
            row["page_table"] = tmp_dev
        next_tok, row_cache = self.prefill_step(
            self.params, {"tokens": self._prompt(req)}, row_cache
        )
        ids_dev = torch.tensor(ids, dtype=torch.int64, device=self.device)
        for full, row in zip(self.cache, row_cache):
            # the scratch pages (temp ids 1..need) land on the granted ids
            full["k_pages"].index_copy_(0, ids_dev, row["k_pages"][1:need + 1])
            full["v_pages"].index_copy_(0, ids_dev, row["v_pages"][1:need + 1])
            full["pos"][slot] = row["pos"][0]
        self._cache_pos[slot] = len(req.prompt)
        self.slot_pages[slot] = list(ids)
        self._page_table[slot] = 0
        self._page_table[slot, :need] = ids
        self._table_dirty = True
        return next_tok

    def _release_slot(self, slot: int) -> None:
        """Paged mode: free a slot's pages and reset its cache position.
        A dense slot keeps its position running, as the reference's
        ``_release_pages`` leaves it: past ``max_len`` the linear cache
        writes at its last row and every row is valid, so an idle slot's
        token attends to what the reference's does."""
        if self.paged is None:
            return
        if self.slot_pages[slot]:
            self.page_pool.free(self.slot_pages[slot])
            self.slot_pages[slot] = []
        self._page_table[slot] = 0  # back to the scratch page
        self._table_dirty = True
        self._reset_slot_pos(slot)

    def _reset_slot_pos(self, slot: int) -> None:
        """Zero the device-cache decode position of a freed paged slot in
        every attention layer, as the reference's ``_release_pages``
        does.  An empty slot still rides the decode step (shapes are
        static), so its cache ``pos`` advances every tick from there."""
        for layer in self.cache:
            if "pos" in layer:
                layer["pos"][slot] = 0
        self._cache_pos[slot] = 0

    def _sync_page_table(self) -> None:
        if self.paged is None or not self._table_dirty:
            return
        # one device copy, shared by every layer's cache
        table = torch.tensor(self._page_table, device=self.device)
        for layer in self.cache:
            layer["page_table"] = table
        self._table_dirty = False

    def _check_kernel_indices(self) -> None:
        """Host range check of what the decode kernels will index with,
        once per tick: an active slot past its cache raises.  An idle
        slot's position runs on past its table row or linear cache, as
        the reference's does; the attention layer maps what it writes
        and reads back into the cache."""
        cap = self._pos_cap
        for slot in np.flatnonzero(self._cache_pos >= cap):
            if self.active[slot] is not None:
                raise RuntimeError(
                    f"slot {slot} decodes at position {self._cache_pos[slot]} "
                    f"past its cache ({cap} rows)"
                )
        if self.paged is None:
            return
        if self._page_table.min() < 0 or self._page_table.max() >= self.paged.num_pages:
            raise ValueError(
                f"page table holds ids outside [0, {self.paged.num_pages})"
            )

    def _stall(self, msg: Message) -> None:
        """Park ``msg`` for retry ahead of the live queue, keeping
        ``_stalled`` sorted by arrival (enqueued_at, then req_id).  A
        preempted request is the oldest work in flight; appended at the
        tail it would requeue behind younger stalled arrivals and become
        the repeat preemption victim under pressure."""

        def key(m: Message):
            r = m.payload
            at = r.enqueued_at if r.enqueued_at is not None else m.created_at
            return (at, r.req_id)

        idx = len(self._stalled)
        for i, other in enumerate(self._stalled):
            if key(msg) < key(other):
                idx = i
                break
        self._stalled.insert(idx, msg)

    def _preempt(self, slot: int) -> None:
        """Evict a running slot: free its pages, requeue the request
        undecoded (ahead of the queue)."""
        req = self.active[slot]
        self.active[slot] = None
        self.outputs[slot] = []
        self.budgets[slot] = 0
        self.positions[slot] = 0
        self._release_slot(slot)
        self.preemptions += 1
        if req is not None:
            req.reset_for_readmission()
            self._stall(
                Message(topic="serve", payload=req,
                        created_at=req.enqueued_at or 0.0)
            )

    def _ensure_pages(self) -> None:
        """Grant each active slot the page its next write lands in;
        preempt slots the pool cannot serve."""
        if self.paged is None:
            return
        for slot in range(self.slots):
            if self.active[slot] is None:
                continue
            idx = int(self.positions[slot]) // self.paged.page_size
            if idx < len(self.slot_pages[slot]):
                continue
            got = self.page_pool.alloc(1)
            if got is None:
                self._preempt(slot)
                continue
            self._page_table[slot, len(self.slot_pages[slot])] = got[0]
            self.slot_pages[slot].extend(got)
            self._table_dirty = True

    def _finish(self, slot: int, now: float) -> None:
        req = self.active[slot]
        if req is not None:
            req.output = list(self.outputs[slot])
            req.completed_at = now
            self.completed.append(req)
        self.active[slot] = None
        self.outputs[slot] = []
        self.budgets[slot] = 0
        self._release_slot(slot)

    def _fail(self, req: Request, reason: str, now: float) -> None:
        req.fail_reason = reason
        req.output = []
        req.completed_at = now
        self.completed.append(req)

    def _next_message(self) -> Optional[Message]:
        """Stalled requests (blocked on pages earlier) go first, keeping
        arrival order; then the live queue."""
        if self._stalled:
            return self._stalled.pop(0)
        return self.queue.get()

    @torch.inference_mode()
    def step(self, now: float = 0.0) -> int:
        """Admit from the queue into free slots, then run one decode step
        for the occupied ones.  Returns the number of tokens decoded."""
        occupied = self.occupancy()
        for slot in range(self.slots):
            if occupied >= self.slots:
                break
            if self.active[slot] is None:
                msg = self._next_message()
                if msg is None:
                    break
                req = msg.payload
                if not req.prompt or len(req.prompt) > self.max_len - 1:
                    # Unservable at any pool state: an empty prompt has
                    # nothing to prefill, and a prompt at/over max_len
                    # leaves no room for even one decoded token.
                    self.rejected_invalid += 1
                    self._fail(req, "invalid", now)
                    continue
                if (
                    self.paged is not None
                    and not self.page_pool.fits(
                        min(len(req.prompt) + req.max_new_tokens, self.max_len)
                    )
                ):
                    # Larger than the whole pool: it could never run even
                    # with every page to itself.  Fail it rather than
                    # livelock through endless preemption.
                    self.rejected_oversize += 1
                    self._fail(req, "oversize", now)
                    continue
                if not self._admit(slot, req):
                    # pool can't grant the prompt's pages right now; wait
                    # at the head of the line for a finish/preemption.
                    self.admit_stalls += 1
                    self._stall(msg)
                    break
                occupied += 1

        if self.occupancy() == 0:
            return 0

        # Grant each slot the page its next token lands in (may preempt).
        self._ensure_pages()
        if self.occupancy() == 0:
            return 0
        self._sync_page_table()
        self._check_kernel_indices()

        tokens = torch.tensor(self.cur_tokens, device=self.device)
        positions = torch.tensor(self.positions, device=self.device)
        next_tok, self.cache = self.decode_step(
            self.params, tokens, self.cache, positions
        )
        next_np = next_tok.cpu().numpy()
        self._cache_pos += 1
        decoded = 0
        for slot in range(self.slots):
            if self.active[slot] is None:
                continue
            decoded += 1
            tok = int(next_np[slot])
            self.outputs[slot].append(tok)
            self.positions[slot] += 1
            self.budgets[slot] -= 1
            self.cur_tokens[slot, 0] = tok
            hit_eos = self.eos >= 0 and tok == self.eos
            if self.budgets[slot] <= 0 or hit_eos or (
                self.positions[slot] >= self.max_len - 1
            ):
                self._finish(slot, now)
        self.steps += 1
        return decoded

    def run_until_drained(self, max_steps: int = 10_000, now: float = 0.0) -> int:
        n = 0
        for _ in range(max_steps):
            if self.occupancy() == 0 and self.queue_depth() == 0:
                break
            n += self.step(now)
        return n
