"""Continuous-batching serving engine.

Counterpart of ``compressed_tensors_tpu/engine/serving.py``: fixed-slot
continuous batching over a per-slot dense KV cache or a paged pool.
Requests queue up; finished slots are released and refilled by prefilling
the next request into the freed slot while the other slots keep decoding.
Slot, page and prefix bookkeeping is on the host; steps run eagerly.

With a ``mesh`` every rank runs the engine on its slice of the params
(``parallel/mesh.py``); the forward gathers the vocabulary-sharded logits,
so the argmax, and with it every host-side decision, is the same on every
rank.

Under data parallelism (a mesh with dp > 1 that divides ``max_batch``) a
slot belongs to the dp block that holds its row (``dp_rows``), and every
rank keeps the same slots, queue, pages, prefix index and preemption
state. A prefill runs on the ranks of the slot's block only, so the
blocks prefill their own slots side by side, and the first tokens of the
prompts admitted in a step are all-gathered over "dp" once, at the end of
the admission (a broadcast per prompt would make each block wait for the
other's prefills). A decode step runs on every rank over its own block, also one
whose rows are all inactive, so that it joins every collective; each rank
keeps its (burst, B/dp) token trace on the device and all-gathers it over
"dp" once, at the burst's end. The dense cache holds the rank's block of
slots; the paged pool is whole on every rank, and each rank writes the
pages of its own slots only. A prefix-cache hit can point a slot at a
page that the other block wrote: the host records which block wrote each
registered page, and when a slot of another block first hits it, the
page's K/V rows are broadcast over "dp" from the writing block (then
every block holds it until it is evicted). Copying at the first
cross-block hit moves only pages that another block reads; a copy at
registration would move every registered page, most of which are read
by their own block or not at all. The dp collectives are broadcasts and
all-gathers only, which gloo also carries for CUDA tensors.

Three things differ from the JAX engine, with the same completions:

- A prefill chunk runs the forward over the slot's row only, with a
  one-row view of the cache (``k[:, slot:slot+1]`` of the dense cache, or
  the slot's page-table row over the shared pool), and the lm_head only at
  the chunk's last position. The JAX engine, which needs static shapes
  under jit, runs all rows with the others inactive. One consequence:
  ``_w4b8_mode`` sees the chunk's rows, not B times them.
- A chunk runs at its real length. The JAX engine pads a ragged chunk to
  a power-of-two bucket to bound the shapes jit compiles; eager steps
  compile nothing, so padding would only add work.
- Slot lengths and page tables live on the host (numpy) and go to the
  device once per forward (per burst for decode), so the bookkeeping never
  waits on the card. A ``steps_per_sync`` burst runs k eager decode steps
  with the tokens kept on the device and copies the (k, B) token trace to
  the host once at its end.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict, deque
from typing import Optional

import numpy as np
import torch

from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.models.llama import (
    KVCache,
    PagedKVCache,
    init_kv_cache,
    init_paged_kv_cache,
    llama_forward,
    resolve_device,
    transcode_fp8_kv_to_int8,
)
from compressed_tensors_tpu_torch.parallel.mesh import dp_rows, local_config
from compressed_tensors_tpu_torch.utils.dtypes import byte_view

__all__ = ["ServingEngine", "Request", "Completion"]


class _PoolExhausted(Exception):
    """Internal: the paged KV pool has no free page (preemption signal)."""


@dataclasses.dataclass
class Request:
    request_id: int
    prompt_ids: list[int]
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    # resume state carried across preemption: tokens already generated (the
    # last one is the pending next-input token). Engine-internal.
    _generated: list[int] = dataclasses.field(default_factory=list,
                                              repr=False)


@dataclasses.dataclass
class Completion:
    request_id: int
    prompt_ids: list[int]
    output_ids: list[int]
    finish_reason: str  # "stop" | "length"


class ServingEngine:
    """Fixed-slot continuous batching engine.

    :param params: model params (compressed weights, on ``device``)
    :param config: model config
    :param max_batch: number of concurrent sequence slots
    :param max_len: per-slot KV capacity (prompt + generation)
    :param prefill_chunk: tokens per prefill forward (the prompt's last
        chunk runs at its real length)
    :param steps_per_sync: decode steps per host round trip; a slot that
        finishes mid-burst wastes at most steps_per_sync-1 token
        computations (its extra tokens are truncated on the host)
    :param cache_dtype: KV cache dtype (default the compute dtype); fp8
        e4m3 or int8 caches hold K/V divided by the layers'
        ``k_scale``/``v_scale``. Under ``fp8_transcode="always"`` an fp8
        cache becomes int8 with rescaled scales, as in the JAX engine.
    :param paged: a page pool with per-slot page tables (page 0 is the null
        page), with sha256 prefix caching and newest-first preemption
    :param num_pages: pool size (default: full residency plus the null page)
    :param mesh: a ``parallel.make_mesh`` mesh: the params are sharded
        over it (``shard_llama_params``; a rank's already sharded params
        are taken as they are) and the cache holds this rank's kv heads.
        Every rank runs the same host-side slot, page and prefix
        bookkeeping on the same gathered logits, so the ranks take the
        same decisions. The engine then runs on ``mesh.device`` (in place
        of ``device``). A dp axis that divides ``max_batch`` splits the
        slots into blocks (module docstring); one that does not leaves
        every rank all the slots, with nothing gathered
    :param device: where the engine runs; CUDA unless the caller asks for
        the CPU
    """

    def __init__(
        self,
        params,
        config: LlamaConfig,
        max_batch: int = 8,
        max_len: int = 512,
        prefill_chunk: int = 64,
        dtype=torch.bfloat16,
        cache_dtype=None,
        steps_per_sync: int = 1,
        paged: bool = False,
        page_size: int = 64,
        num_pages: Optional[int] = None,
        prefix_caching: bool = True,
        use_kernels: bool = True,
        mesh=None,
        device="cuda",
    ):
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        params, cache_dtype = transcode_fp8_kv_to_int8(params, cache_dtype)
        if mesh is not None:
            from compressed_tensors_tpu_torch.parallel.mesh import (
                shard_llama_params,
            )

            # full params are sharded here; a rank's own slice (already
            # sharded, e.g. by load_llama_params(mesh=...)) is kept
            if params.get("shard") is None:
                params = shard_llama_params(params, mesh, config)
        self.mesh = mesh
        self.params = params
        self.config = config
        # the caches hold this rank's kv heads; the dense cache this rank's
        # dp block of the slots (all of them without a dp split)
        cache_config = local_config(params, config)
        self._rows = (dp_rows(mesh, max_batch) if mesh is not None
                      else slice(0, max_batch))
        self._dp_split = self._rows != slice(0, max_batch)
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.dtype = dtype
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.paged = paged
        self.prefix_caching = paged and prefix_caching
        self.use_kernels = use_kernels

        # host-side slot lengths (the device copy is made per forward)
        self._lengths = np.zeros((max_batch,), np.int32)
        if paged:
            self.cache = init_paged_kv_cache(
                cache_config, max_batch, max_len, num_pages=num_pages,
                page_size=page_size, dtype=dtype, cache_dtype=cache_dtype,
                device=self.device)
            # host-side page allocator: free list over the pool (page 0 is
            # the null page), per-slot owned-page lists, host page tables
            self._tables = np.zeros(tuple(self.cache.tables.shape), np.int32)
            self._free_pages = deque(range(1, self.cache.k.shape[1]))
            self._slot_pages: list[list[int]] = [[] for _ in range(max_batch)]
            # automatic prefix caching: full prompt pages are
            # content-addressed by a sha256 hash chain over (parent digest,
            # page tokens). Refcount-0 registered pages park in an LRU of
            # reusable free pages and are only evicted (index removal) when
            # the plain free list runs dry.
            self._page_ref: dict[int, int] = {}
            self._prefix_index: dict[bytes, int] = {}
            self._page_digest: dict[int, bytes] = {}
            self._cached_free: "OrderedDict[int, bytes]" = OrderedDict()
            # dp: the block that wrote each registered page, and the
            # registered pages every block holds
            self._page_writer: dict[int, int] = {}
            self._page_shared: set[int] = set()
        else:
            self.cache = init_kv_cache(cache_config,
                                       self._rows.stop - self._rows.start,
                                       max_len,
                                       dtype=dtype, cache_dtype=cache_dtype,
                                       device=self.device)
        self.prefix_cache_hits = 0  # pages reused across requests
        # of them, pages another dp block wrote
        self.cross_block_hits = 0
        self.tokens = torch.zeros((max_batch,), dtype=torch.int32,
                                  device=self.device)

        self.slot_requests: list[Optional[Request]] = [None] * max_batch
        self.slot_outputs: list[list[int]] = [[] for _ in range(max_batch)]
        self.queue: deque[Request] = deque()
        self.completions: list[Completion] = []
        # admission order (preemption victims are newest-first)
        self._seq = 0
        self._slot_seq = [0] * max_batch
        self.preemptions = 0

    # ------------------------------------------------------------------ #
    # forwards

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A device copy of host bookkeeping, on the current stream."""
        return torch.tensor(a, device=self.device)

    def _block(self, slot: int) -> int:
        """The dp block that holds ``slot`` (0 without a dp split)."""
        return slot // (self._rows.stop - self._rows.start)

    def _owns(self, slot: int) -> bool:
        return self._rows.start <= slot < self._rows.stop

    def _first_tokens(self, first: dict) -> None:
        """Record the prefill tokens of the slots one ``_admit`` filled
        (slot -> device scalar, None for another block's slot): over a dp
        split each block computed its own, and one all-gather over "dp"
        hands every rank all of them."""
        if not first:
            return
        slots = list(first)
        if self._dp_split:
            local = torch.zeros((self._rows.stop - self._rows.start,),
                                dtype=torch.int32, device=self.device)
            for slot, token in first.items():
                if self._owns(slot):
                    local[slot - self._rows.start] = token
            new = self.mesh.all_gather(local, "dp", dim=0)[slots]
        else:
            new = torch.stack([first[slot] for slot in slots])
        self.tokens[slots] = new
        for slot, token in zip(slots, new.tolist()):
            self.slot_outputs[slot] = [token]

    def _prefill_chunk(self, slot: int, piece: list[int],
                       start: int) -> torch.Tensor:
        """Forward ``piece`` of one slot at ``start``; returns the next
        token (a device scalar)."""
        positions = torch.arange(start, start + len(piece),
                                 device=self.device)
        local = slot - self._rows.start   # the slot's row of the dense cache
        if self.paged or len(piece) > 1:
            # one row: the slot's view of the cache
            if self.paged:
                cache = PagedKVCache(
                    k=self.cache.k, v=self.cache.v,
                    tables=self._to_device(self._tables[slot:slot + 1]),
                    lengths=self._to_device(np.asarray([start], np.int32)))
            else:
                cache = KVCache(
                    k=self.cache.k[:, local:local + 1],
                    v=self.cache.v[:, local:local + 1],
                    lengths=self._to_device(np.asarray([start], np.int32)))
            row = 0
            input_ids = self._to_device(np.asarray([piece], np.int64))
            positions = positions[None]
        else:
            # a one-token chunk on the dense cache takes the decode kernel,
            # which needs the whole contiguous cache (this rank's block):
            # every other row is inactive (length -1) and left untouched
            n = self.cache.k.shape[1]
            lengths = np.full((n,), -1, np.int32)
            lengths[local] = start
            cache = KVCache(k=self.cache.k, v=self.cache.v,
                            lengths=self._to_device(lengths))
            row = local
            all_ids = np.zeros((n, 1), np.int64)
            all_ids[local, 0] = piece[0]
            input_ids = self._to_device(all_ids)
            positions = positions[None].expand(n, 1)
        logits, _ = llama_forward(
            self.params, self.config, input_ids, positions, cache,
            fresh_prefill=start == 0, use_kernels=self.use_kernels,
            last_logit_only=True)
        return torch.argmax(logits[row, 0]).to(torch.int32)

    def _decode(self, active: np.ndarray, burst: int) -> np.ndarray:
        """``burst`` decode steps of every active slot of this rank's
        block, tokens kept on the device; returns the (burst, B) token
        trace (one host copy, after one all-gather over "dp")."""
        rows = self._rows
        active_d = self._to_device(active[rows])
        len0 = self._to_device(self._lengths[rows])
        tables = self._to_device(self._tables[rows]) if self.paged else None
        tokens = self.tokens[rows]
        trace = []
        for i in range(burst):
            lengths = torch.where(active_d, len0 + i, -1).to(torch.int32)
            if self.paged:
                cache = PagedKVCache(k=self.cache.k, v=self.cache.v,
                                     tables=tables, lengths=lengths)
            else:
                cache = KVCache(k=self.cache.k, v=self.cache.v,
                                lengths=lengths)
            logits, _ = llama_forward(
                self.params, self.config, tokens[:, None], lengths[:, None],
                cache, use_kernels=self.use_kernels,
                dp_block=self._dp_split)
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            tokens = torch.where(active_d, nxt, tokens)
            trace.append(tokens)
        trace = torch.stack(trace)
        if self._dp_split:
            # every block's tokens, once a burst
            trace = self.mesh.all_gather(trace, "dp", dim=1)
            tokens = trace[-1].clone()
        self.tokens = tokens
        self._lengths[active] += burst
        return trace.cpu().numpy()

    # ------------------------------------------------------------------ #
    def submit(self, request: Request) -> None:
        if request.max_new_tokens >= self.max_len:
            # capacity invariant: prompt truncation computes
            # ids[-(max_len - max_new_tokens):], which needs a positive
            # budget, and decode must never write past max_len. Clamp into
            # an engine-internal copy, never the caller's Request.
            request = dataclasses.replace(
                request, max_new_tokens=self.max_len - 1,
                _generated=list(request._generated))
        self.queue.append(request)

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_requests) if r is None]

    def _alloc_page(self) -> int:
        """Pop a free page; evict the LRU refcount-0 prefix-cached page
        when the plain free list is dry."""
        if self._free_pages:
            return self._free_pages.popleft()
        if self._cached_free:
            pid, digest = self._cached_free.popitem(last=False)
            del self._prefix_index[digest]
            del self._page_digest[pid]
            del self._page_writer[pid]
            self._page_shared.discard(pid)
            return pid
        raise _PoolExhausted

    def _ensure_pages(self, slot: int, upto_len: int) -> None:
        """Allocate pages so ``slot``'s table covers positions [0,
        upto_len). Transactional: on pool exhaustion every page grabbed by
        this call returns to the free list before the exception
        propagates (the caller preempts or requeues)."""
        page = self.cache.page_size
        need = -(-min(upto_len, self.max_len) // page)
        owned = self._slot_pages[slot]
        if need <= len(owned):
            return
        grabbed: list[int] = []
        try:
            for _ in range(need - len(owned)):
                grabbed.append(self._alloc_page())
        except _PoolExhausted:
            self._free_pages.extend(grabbed)
            raise
        for i, pid in enumerate(grabbed, start=len(owned)):
            self._page_ref[pid] = 1
            self._tables[slot, i] = pid
        owned.extend(grabbed)

    def _release_slot_pages(self, slot: int) -> None:
        """Drop the slot's page refs; refcount-0 pages return to the pool:
        prefix-registered ones park in the reusable LRU, the rest go to the
        free list. The table row points back at the null page."""
        if not (self.paged and self._slot_pages[slot]):
            return
        for pid in self._slot_pages[slot]:
            self._page_ref[pid] -= 1
            if self._page_ref[pid] == 0:
                del self._page_ref[pid]
                if pid in self._page_digest:
                    self._cached_free[pid] = self._page_digest[pid]
                else:
                    self._free_pages.append(pid)
        self._slot_pages[slot] = []
        self._tables[slot] = 0

    def _preempt_newest(self) -> Optional[int]:
        """Preempt the most recently admitted active slot: free its pages
        and requeue its request (at the queue front) with the generated
        prefix carried as resume state, so re-admission prefills
        prompt+generated and decoding continues exactly where it stopped.
        Returns the victim slot, or None if no slot is active."""
        cands = [s for s, r in enumerate(self.slot_requests) if r is not None]
        if not cands:
            return None
        victim = max(cands, key=lambda s: self._slot_seq[s])
        req = self.slot_requests[victim]
        req._generated = list(self.slot_outputs[victim])
        self.queue.appendleft(req)
        self.slot_requests[victim] = None
        self.slot_outputs[victim] = []
        self._release_slot_pages(victim)
        self.preemptions += 1
        return victim

    @staticmethod
    def _page_digests(ids: list[int], page: int) -> list[bytes]:
        """sha256 hash chain over the prompt's full pages."""
        digests = []
        d = b"ct-tpu-prefix-root"
        for i in range(len(ids) // page):
            d = hashlib.sha256(
                d + np.asarray(ids[i * page:(i + 1) * page],
                               np.int64).tobytes()).digest()
            digests.append(d)
        return digests

    def _match_prefix(self, slot: int, ids: list[int]) -> int:
        """Point ``slot``'s leading table entries at cached pages matching
        the longest full-page prompt prefix; returns the matched token
        count (always < len(ids) so the final token is recomputed for its
        logits)."""
        page = self.cache.page_size
        digests = self._page_digests(ids, page)
        if digests and len(digests) * page == len(ids):
            digests = digests[:-1]  # keep >= 1 token to prefill
        matched: list[int] = []
        for d in digests:
            pid = self._prefix_index.get(d)
            if pid is None:
                break
            matched.append(pid)
        if not matched:
            return 0
        for i, pid in enumerate(matched):
            self._cached_free.pop(pid, None)  # back in active use
            self._page_ref[pid] = self._page_ref.get(pid, 0) + 1
            self._tables[slot, i] = pid
        self._slot_pages[slot] = list(matched)
        self.prefix_cache_hits += len(matched)
        self._share_pages(slot, matched)
        return len(matched) * page

    def _share_pages(self, slot: int, pids: list[int]) -> None:
        """Broadcast over "dp" the K/V rows of the pages in ``pids`` that
        ``slot``'s block has not got, from the blocks that wrote them (on
        every rank, in the same order: the host state is the same)."""
        if not self._dp_split:
            return
        block = self._block(slot)
        by_writer: dict[int, list[int]] = {}
        for pid in pids:
            writer = self._page_writer[pid]
            if writer != block:
                self.cross_block_hits += 1
                if pid not in self._page_shared:
                    by_writer.setdefault(writer, []).append(pid)
        for writer, group in sorted(by_writer.items()):
            idx = torch.tensor(group, device=self.device)
            for pool in (self.cache.k, self.cache.v):
                rows = byte_view(pool)[:, idx]   # a copy, moved as bytes
                self.mesh.broadcast(rows.view(torch.uint8), "dp", writer)
                byte_view(pool)[:, idx] = rows
            self._page_shared.update(group)

    def _register_prefix(self, slot: int, ids: list[int]) -> None:
        """Content-address the slot's now-full prompt pages for reuse."""
        page = self.cache.page_size
        owned = self._slot_pages[slot]
        for i, d in enumerate(self._page_digests(ids, page)):
            if i >= len(owned):
                break
            pid = owned[i]
            if d not in self._prefix_index and pid not in self._page_digest:
                self._prefix_index[d] = pid
                self._page_digest[pid] = d
                self._page_writer[pid] = self._block(slot)

    def _admit(self) -> None:
        """Prefill queued requests into free slots (chunked). A preempted
        request resumes here: its prompt+generated prefix is prefilled and
        its pending next token restored, so generation continues exactly
        where preemption stopped."""
        first = {}   # slot -> its prefill token
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            gen = list(req._generated)
            ids = list(req.prompt_ids) + gen[:-1]
            # remaining decode writes: max_new - len(gen) (non-resumed:
            # max_new - 1 decode writes + 1 is the prefill-produced token)
            budget = req.max_new_tokens - max(0, len(gen) - 1)
            if len(ids) + budget > self.max_len:
                ids = ids[-(self.max_len - budget):]
            self._lengths[slot] = 0
            start = 0
            if self.paged:
                if self.prefix_caching:
                    # reuse cached pages for the longest full-page prompt
                    # prefix; prefill resumes after it
                    start = self._match_prefix(slot, ids)
                try:
                    # prompt + the first decode step's write position
                    self._ensure_pages(slot, len(ids) + 1)
                except _PoolExhausted:
                    # admission never preempts (running requests have
                    # priority): release anything grabbed (matched prefix
                    # pages included), requeue, and wait for decodes to
                    # retire. If nothing is decoding, no page will ever
                    # free: fail loudly.
                    self._release_slot_pages(slot)
                    self.queue.appendleft(req)
                    if not any(r is not None for r in self.slot_requests):
                        raise RuntimeError(
                            "paged KV pool exhausted: a single sequence "
                            "needs more pages than the pool holds; raise "
                            "num_pages or lower max_len") from None
                    break
            chunk = self.prefill_chunk
            next_token = None
            if self._owns(slot):
                while start < len(ids):
                    piece = ids[start:start + chunk]
                    next_token = self._prefill_chunk(slot, piece, start)
                    start += len(piece)
                    self._lengths[slot] = start
            else:
                # another dp block prefills the slot
                self._lengths[slot] = len(ids)
            if self.prefix_caching:
                self._register_prefix(slot, ids)
            if gen:
                # resumed: restore the pending next-input token; the
                # prefill's recomputed argmax is the same token (greedy)
                self.tokens[slot] = gen[-1]
                self.slot_outputs[slot] = gen
                req._generated = []
            else:
                first[slot] = next_token
            self.slot_requests[slot] = req
            self._seq += 1
            self._slot_seq[slot] = self._seq
        self._first_tokens(first)

    def _retire(self) -> None:
        """Release finished slots."""
        for slot, req in enumerate(self.slot_requests):
            if req is None:
                continue
            out = self.slot_outputs[slot]
            finished_len = len(out) >= req.max_new_tokens
            finished_cap = int(self._lengths[slot]) >= self.max_len - 1
            finished_eos = (req.eos_token_id is not None and len(out) > 0
                            and out[-1] == req.eos_token_id)
            if finished_len or finished_eos or finished_cap:
                self.completions.append(Completion(
                    request_id=req.request_id,
                    prompt_ids=list(req.prompt_ids),
                    output_ids=list(out),
                    finish_reason="stop" if finished_eos else "length"))
                self.slot_requests[slot] = None
                self.slot_outputs[slot] = []
                self._release_slot_pages(slot)

    def _ensure_burst_pages(self, burst: int) -> int:
        """Cover every active slot's burst write positions; pool pressure
        preempts the newest active slot until the rest fit. Returns the
        (possibly shortened) burst."""
        for slot in range(self.max_batch):
            while self.slot_requests[slot] is not None:
                try:
                    self._ensure_pages(slot, int(self._lengths[slot]) + burst)
                    break
                except _PoolExhausted:
                    cands = [s for s, r in enumerate(self.slot_requests)
                             if r is not None]
                    victim = max(cands, key=lambda s: self._slot_seq[s])
                    if victim == slot:
                        # preempting this slot cannot make room for its own
                        # burst (re-admission fails the same way): shrink
                        # the burst first; self-preempt only if other slots
                        # can still make progress and free pages later
                        if burst > 1:
                            burst = 1
                            continue
                        if len(cands) == 1:
                            raise RuntimeError(
                                "paged KV pool exhausted: the last active "
                                "sequence cannot cover its next decode "
                                "write even at burst=1; raise num_pages or "
                                "lower max_len") from None
                    self._preempt_newest()
        return burst

    def step(self) -> None:
        """One engine iteration: admit, decode (burst), collect, retire."""
        self._retire()
        self._admit()
        # a prompt's first generated token may already finish the request
        self._retire()
        if not any(r is not None for r in self.slot_requests):
            return
        # burst length: bounded by the tightest remaining budget/capacity so
        # no slot writes past its cache or computes far past its stop
        burst = self.steps_per_sync
        for slot, req in enumerate(self.slot_requests):
            if req is None:
                continue
            remaining = req.max_new_tokens - len(self.slot_outputs[slot])
            cap = self.max_len - 1 - int(self._lengths[slot])
            burst = min(burst, max(1, min(remaining, cap)))
        if self.paged:
            burst = self._ensure_burst_pages(burst)
        active = np.asarray([r is not None for r in self.slot_requests])
        if not active.any():
            return
        trace = self._decode(active, burst)
        for slot, req in enumerate(self.slot_requests):
            if req is None:
                continue
            out = self.slot_outputs[slot]
            for k in range(trace.shape[0]):
                if len(out) >= req.max_new_tokens:
                    break
                if (req.eos_token_id is not None and out
                        and out[-1] == req.eos_token_id):
                    break  # truncate tokens generated past EOS mid-burst
                out.append(int(trace[k, slot]))
        self._retire()

    def run(self, max_steps: int = 10_000) -> list[Completion]:
        """Run until all submitted requests complete."""
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_requests)) \
                and steps < max_steps:
            self.step()
            steps += 1
        done = self.completions
        self.completions = []
        return done
