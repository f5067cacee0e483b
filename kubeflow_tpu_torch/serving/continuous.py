"""Continuous batching for LM serving: slot-based lockstep decode (port
of kubeflow_tpu/serving/continuous.py: dense, paged and speculative).

A fixed pool of S slots decodes in lockstep, one token per slot per
tick, each slot at its own position (the model's per-row
`decode_index`). Requests join at a tick boundary (prefilled apart,
then installed into a free slot's cache rows, or written straight into
their pages) and leave when their own budget is done, so a long
generation never holds a short one back.

- dense: per-slot [S, max_seq] cache rows; an idle decoder prefills a
  burst of waiting prompts as one batch (`_PREFILL_SIZES`).
- paged (the model was built with kv_pages / kv_page_size): a
  PageAllocator gates admission on free pages, prompts reuse shared
  prefix pages, and each admission prefills only its uncached suffix.
- speculative (`draft_model` given; greedy only, dense or paged target,
  dense draft): each round the draft proposes draft_k tokens for every
  busy slot and the target verifies every slot's chunk in one
  [S, draft_k + 1] forward; each slot accepts its own prefix, and the
  tokens equal plain greedy decode (runtime/speculative.py).

The state (cache, last logits, positions, budgets, output columns,
pads, the sampling generator) lives on the device and is updated in
place by each call; a call that fails leaves it unknown, so the loop
fails every waiter and rebuilds it fresh. Params are an argument of
every call, never captured.

Over a serving mesh (`mesh=`, serving/mesh.py; dense cache only, no
draft) every rank holds a decoder over its shards of the model, its
cache at this rank's kv heads. Admission, eviction and deadline
cancellation stay on rank 0, whose loop runs each device call (a
prefill and install, a slot clear, one or FUSE ticks) as a meshed op:
the other ranks repeat it on their replica of the state, in the same
order; with temperature > 0 rank 0's sampled tokens are shared.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time

import numpy as np
import torch

from kubeflow_tpu_torch.runtime.generate import (
    _sample,
    check_decode_geometry,
    generator,
    init_cache,
    prefill_scan,
)
from kubeflow_tpu_torch.runtime.kvcache import (
    PageAllocator,
    copy_pages,
    init_paged_cache,
    pages_for,
)
from kubeflow_tpu_torch.parallel.shardings import COLLECTIVES
from kubeflow_tpu_torch.runtime.metrics import REGISTRY as METRICS_REGISTRY
from kubeflow_tpu_torch.runtime.speculative import (
    check_speculative_models,
    greedy_accept,
    lockstep_propose,
    lockstep_verify,
)
from kubeflow_tpu_torch.serving.router import DeadlineExceeded

log = logging.getLogger("kubeflow_tpu_torch.serving.continuous")

# the dense decoder's device calls, as meshed ops
_ADMIT, _CLEAR, _STEP = 0, 1, 2

# Ticks run back to back, without a host readback between them, when
# nothing waits (or no slot is free) and every active slot has at least
# this many tokens to go: the reference fuses them into one program, the
# port runs them eagerly, so admission timing is the same.
FUSE = 8


class _DecodeMeter:
    """Per-replica decode signals in the port's metrics registry (the
    reference also mirrors them into prometheus_client)."""

    def __init__(self, model: str, registry=METRICS_REGISTRY):
        self.model = model
        self.registry = registry

    def pages(self, free: int, used: int) -> None:
        self.registry.gauge(
            "serving_kv_pages_free", free,
            help_="KV-cache pages available for admission", model=self.model)
        self.registry.gauge(
            "serving_kv_pages_used", used,
            help_="KV-cache pages held by live or cached-prefix sequences",
            model=self.model)

    def prefix_hits(self, pages: int) -> None:
        self.registry.counter_inc(
            "serving_prefix_cache_hits_total", by=float(pages),
            help_="prompt pages served from the shared prefix cache "
                  "(each hit skips page_size positions of prefill)",
            model=self.model)

    def prefill_tokens(self, n: int) -> None:
        if n <= 0:
            return
        self.registry.counter_inc(
            "serving_prefill_tokens_total", by=float(n),
            help_="prompt positions actually computed by prefill "
                  "(prefix reuse drives this below tokens submitted)",
            model=self.model)

    def ticks(self, n: int, seconds: float, collective_host_seconds: float
              ) -> None:
        self.registry.counter_inc(
            "serving_decode_ticks_total", by=float(n),
            help_="lockstep decode ticks (one token per active slot)",
            model=self.model)
        self.registry.counter_inc(
            "serving_decode_tick_seconds_total", by=seconds,
            help_="host wall seconds of the ticks, to the readback of "
                  "their state", model=self.model)
        self.registry.counter_inc(
            "serving_decode_collective_host_seconds_total",
            by=collective_host_seconds,
            help_="host seconds the ticks spent blocked in collectives "
                  "(tensor parallelism and the serving mesh's wire): their "
                  "time under gloo, which returns when the data is there; "
                  "near 0 under NCCL, which returns once a collective is "
                  "enqueued",
            model=self.model)

    def spec_round(self, slots: int, accepted: int) -> None:
        self.registry.counter_inc(
            "serving_spec_rounds_total", by=float(slots),
            help_="speculative verify forwards, one per active slot "
                  "per round (tokens emitted / rounds = tokens per "
                  "target forward)", model=self.model)
        # inc by zero keeps the series visible when nothing is accepted
        self.registry.counter_inc(
            "serving_spec_tokens_accepted_total", by=float(accepted),
            help_="draft tokens accepted by the target verify",
            model=self.model)


@dataclasses.dataclass
class DecodeState:
    """The decoder's device state, one row per slot."""

    cache: dict[str, torch.Tensor]
    last: torch.Tensor        # [S, V] f32 logits of each slot's last token
    pos: torch.Tensor         # [S] position the next token is written at
    remaining: torch.Tensor   # [S] tokens still to generate (0: idle)
    out: torch.Tensor         # [S, N] generated tokens
    pads: torch.Tensor        # [S] left-pad length of each slot's prompt
    req: torch.Tensor         # [S] the request's token budget
    gen: torch.Generator


class SlotDecoder:
    """S-slot continuous decoder over a KV-cache LM (`model.apply`,
    `model.cfg`, `model.device`: a TransformerLM or a QuantizedModel).

    `submit(tokens, max_new=None, deadline=None) -> list[int]` blocks
    the calling thread until that request's continuation is done; many
    threads may submit at once. A background thread admits waiting
    requests at tick boundaries and advances every active slot one
    token per tick."""

    def __init__(self, model, params, *, slots: int = 8,
                 prompt_len: int = 128, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 mesh=None, prefix_cache: bool = True, draft_model=None,
                 draft_variables=None, draft_k: int = 4,
                 metrics_name: str | None = None, clock=None):
        self.model = model
        self.mesh = mesh
        self.S = slots
        self.P = prompt_len
        self.N = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.device = model.device
        # absolute deadlines of submit() are values of this clock
        self.clock = clock if clock is not None else time.monotonic
        self.paged = bool(getattr(model.cfg, "kv_pages", 0))
        self.spec = draft_model is not None
        if mesh is not None and self.paged:
            raise ValueError("the paged KV cache is single-chip for now "
                             "(no mesh)")
        if mesh is not None and self.spec:
            raise ValueError("speculative decoding is single-chip for now "
                             "(no mesh)")
        # rank 0's sampled tokens on every rank of a mesh
        self._share = (mesh.share if mesh is not None and temperature > 0
                       else None)
        self.draft_k = draft_k if self.spec else 0
        check_decode_geometry(model, prompt_len,
                              max_new_tokens + self.draft_k)
        if self.spec:
            if temperature != 0.0:
                raise ValueError("speculative lockstep decode is "
                                 "greedy-only (temperature must be 0)")
            if draft_k < 1:
                raise ValueError("draft_k must be >= 1")
            check_speculative_models(model, draft_model)
            if getattr(draft_model.cfg, "kv_pages", 0):
                raise ValueError("the draft model keeps a dense cache "
                                 "(build it without kv_pages)")
            check_decode_geometry(draft_model, prompt_len,
                                  max_new_tokens + draft_k)
            self.draft = draft_model
            self._d_params = draft_variables
        # a slot's longest sequence: prompt, budget, and the verify
        # chunk's overhang past the last token
        self._total_len = prompt_len + max_new_tokens + self.draft_k
        if self.paged:
            cfg = model.cfg
            self.page_size = cfg.kv_page_size
            self._mp = pages_for(self._total_len, self.page_size)
            if cfg.kv_pages - 1 < self._mp:      # page 0 is trash
                raise ValueError(
                    f"kv_pages={cfg.kv_pages} cannot hold even one "
                    f"sequence ({self._mp} pages of {self.page_size} "
                    "needed, page 0 is trash)")
            self.alloc = PageAllocator(
                cfg.kv_pages, self.page_size, slots, self._mp,
                prefix_cache=prefix_cache)
        else:
            self.alloc = None
        self.meter = _DecodeMeter(metrics_name) if metrics_name else None
        self._counters = {
            "admitted": 0, "completed": 0, "peak_active": 0,
            "prefill_tokens_computed": 0, "prompt_tokens_submitted": 0,
            "spec_rounds": 0, "spec_tokens_emitted": 0,
            "spec_tokens_accepted": 0, "spec_drafted": 0,
            "deadline_canceled": 0, "ticks": 0, "tick_seconds": 0.0,
            "collective_host_seconds": 0.0,
        }
        self._params = params
        self._cols = torch.arange(self.N, device=self.device)
        if self.spec:
            self.t_cache = self._fresh_cache()
            self.d_cache = init_cache(self.draft, self.S)
            target_cache = self.t_cache
        else:
            self.state = self._fresh_state()
            target_cache = self.state.cache
        self._cache_bytes = sum(t.numel() * t.element_size()
                                for t in target_cache.values())
        # prefill batch sizes (the smallest >= the waiting count is used)
        self._PREFILL_SIZES = tuple(sorted(
            {n for n in (1, 2, 4, 8, 16, 32) if n < self.S} | {self.S}))
        self._free: list[int] = list(range(self.S))
        self._pending: "queue.Queue[tuple]" = queue.Queue()
        self._carry: tuple | None = None   # page-gated head of the queue
        # orders submit() against close(): an enqueue strictly precedes
        # the shutdown drain, or the caller is refused
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._mesh_id = (mesh.register(self._execute) if mesh is not None
                         else None)
        self._thread = None
        if mesh is None or mesh.rank == 0:    # the others follow rank 0
            self._thread = threading.Thread(
                target=self._loop_spec if self.spec else self._loop,
                daemon=True, name="slot-decoder")
            self._thread.start()

    # -- device state and calls (each updates the state in place) -------

    def _fresh_cache(self) -> dict[str, torch.Tensor]:
        if self.paged:
            return init_paged_cache(self.model, self._mp)
        return init_cache(self.model, self.S)

    def _fresh_state(self) -> DecodeState:
        def zeros(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return DecodeState(
            cache=self._fresh_cache(),
            last=zeros(self.S, self.model.cfg.vocab_size,
                       dtype=torch.float32),
            pos=zeros(self.S), remaining=zeros(self.S),
            out=zeros(self.S, self.N), pads=zeros(self.S), req=zeros(self.S),
            gen=generator(self.device, self.seed))

    def _prefill(self, params, prompts_k, pads_k):
        """A batch of K prompts through a fresh K-row cache: the one
        prefill of generate() (prefill_scan)."""
        cache_k = init_cache(self.model, prompts_k.shape[0])
        return prefill_scan(self.model, params, cache_k, prompts_k, pads_k)

    def _install(self, st: DecodeState, cache_k, logits_k, slots_k, pads_k,
                 news_k) -> DecodeState:
        """Prefilled rows into slots `slots_k` (distinct)."""
        for name, big in st.cache.items():
            big[slots_k] = cache_k[name].to(big.dtype)
        st.last[slots_k] = logits_k
        st.pos[slots_k] = self.P
        st.remaining[slots_k] = news_k
        st.out[slots_k] = 0
        st.pads[slots_k] = pads_k
        st.req[slots_k] = news_k
        return st

    def _clear_slots(self, st: DecodeState, slots_k) -> DecodeState:
        st.remaining[slots_k] = 0
        return st

    def _paged_prefill_install(self, params, st: DecodeState, toks, start,
                               pt_row, pad, slot: int, req_n: int
                               ) -> DecodeState:
        """One request's uncached prompt suffix written into its pages,
        and its slot set up."""
        logits = self.model.apply(params, toks, decode_index=start,
                                  pad_len=pad, page_table=pt_row,
                                  cache=st.cache)
        st.last[slot] = logits[0, -1]
        st.pos[slot] = self.P
        st.remaining[slot] = req_n
        st.out[slot] = 0
        st.pads[slot] = pad[0]
        st.req[slot] = req_n
        return st

    def _apply_copies(self, st: DecodeState, src, dst) -> DecodeState:
        copy_pages(st.cache, src, dst)
        return st

    def _tick(self, params, st: DecodeState, page_table=None) -> DecodeState:
        """One lockstep token for all S slots. Idle slots compute too,
        but the masks freeze their state; their cache writes land past
        the end (dropped), in their own dead rows, or in the trash
        page."""
        active = st.remaining > 0
        tok = _sample(st.last, self.temperature, self.top_k, st.gen)
        if self._share is not None:
            tok = self._share(tok)
        # the token goes to column req - remaining of each active slot
        ncol = st.req - st.remaining
        hot = (self._cols[None, :] == ncol[:, None]) & active[:, None]
        st.out = torch.where(hot, tok[:, None], st.out)
        logits = self.model.apply(params, tok[:, None], decode_index=st.pos,
                                  pad_len=st.pads, page_table=page_table,
                                  cache=st.cache)
        st.pos = torch.where(active, st.pos + 1, st.pos)
        st.remaining = torch.where(active, st.remaining - 1, st.remaining)
        st.last = torch.where(active[:, None], logits[:, 0], st.last)
        return st

    def _step(self, params, st: DecodeState, page_table=None) -> DecodeState:
        return self._tick(params, st, page_table)

    def _op(self, op: int, words=(), tensors=()) -> None:
        """One dense device call on this decoder, or on every rank's
        replica of it over a mesh (rank 0's loop only)."""
        if self.mesh is None:
            self._execute(op, list(words), list(tensors))
        else:
            self.mesh.call(self._mesh_id, op, words, tensors)

    def _execute(self, op: int, words: list, tensors: list) -> None:
        """A dense device call: _ADMIT (prompts, pads, slots, budgets and
        the dummy rows' slots of a prefill batch), _CLEAR (slots) or
        _STEP (words[0]: FUSE ticks or one)."""
        ids = [self._ids(t) for t in tensors]
        if op == _ADMIT:
            prompts, pads, slots, news, dummies = ids
            cache_k, logits_k = self._prefill(self._params, prompts, pads)
            self.state = self._install(self.state, cache_k, logits_k, slots,
                                       pads, news)
            del cache_k
            if dummies.numel():
                self.state = self._clear_slots(self.state, dummies)
        elif op == _CLEAR:
            self.state = self._clear_slots(self.state, ids[0])
        elif op == _STEP:
            step = self._step_fused if words[0] else self._step
            self.state = step(self._params, self.state)
        else:
            raise ValueError(f"unknown decoder op {op}")

    def _step_fused(self, params, st: DecodeState, page_table=None
                    ) -> DecodeState:
        for _ in range(FUSE):
            st = self._tick(params, st, page_table)
        return st

    # -- host API --------------------------------------------------------

    def submit(self, tokens: list[int], max_new: int | None = None,
               deadline: float | None = None) -> list[int]:
        """Block until this prompt's continuation is decoded. `max_new`
        caps this request's budget below max_new_tokens (a paged decoder
        then reserves fewer pages). `deadline` is an absolute time on
        self.clock: past it the request is cancelled wherever it is
        (queued, carried or mid-decode; its slot and pages go back to
        the pool) and the caller gets DeadlineExceeded."""
        row = [int(t) for t in tokens][-self.P:]
        pad = self.P - len(row)
        return self.submit_padded([0] * pad + row, pad, max_new, deadline)

    def submit_padded(self, padded_row, pad: int, max_new: int | None = None,
                      deadline: float | None = None) -> list[int]:
        """submit() for a row already left-padded to prompt_len."""
        req = self.N if max_new is None else int(max_new)
        if not 1 <= req <= self.N:
            raise ValueError(f"max_new must be in 1..{self.N}, got {req}")
        prompt = np.asarray(padded_row, dtype=np.int64)
        ev = threading.Event()
        sink: list = []
        with self._lock:
            if self._stop:
                raise RuntimeError("decoder shut down")
            self._pending.put((prompt, pad, req, ev, sink, deadline))
        self._wake.set()
        if deadline is None:
            ev.wait()     # the loop sets ev on every exit path
        else:
            # the loop cancels at the next tick boundary; this bound
            # only guards a wedged loop thread
            while not ev.wait(timeout=0.25):
                if self.clock() >= deadline + 30.0:
                    raise DeadlineExceeded(
                        "decoder unresponsive past request deadline")
        if sink and isinstance(sink[0], Exception):
            raise sink[0]
        return sink

    def close(self) -> None:
        with self._lock:
            self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def stats(self) -> dict:
        """Host counters (deterministic, but for the host seconds of the
        dense ticks and of their collectives)."""
        out = dict(self._counters)
        out["mode"] = "paged" if self.paged else "dense"
        out["speculative"] = self.spec
        out["cache_bytes"] = self._cache_bytes
        if self.paged:
            out.update(
                kv_pages_total=self.alloc.num_pages - 1,   # sans trash
                kv_page_size=self.page_size,
                kv_pages_free=self.alloc.free_pages,
                kv_pages_used=self.alloc.used_pages,
                prefix_hit_pages=self.alloc.prefix_hit_pages,
                prefix_hit_tokens=self.alloc.prefix_hit_tokens,
                cow_clones=self.alloc.cow_clones,
            )
        return out

    # -- loop pieces -----------------------------------------------------

    def _count_ticks(self, n: int, seconds: float, collective: float) -> None:
        self._counters["ticks"] += n
        self._counters["tick_seconds"] += seconds
        self._counters["collective_host_seconds"] += collective
        if self.meter:
            self.meter.ticks(n, seconds, collective)

    def _note_active(self, owners) -> None:
        if len(owners) > self._counters["peak_active"]:
            self._counters["peak_active"] = len(owners)

    def _publish_pages(self) -> None:
        if self.meter and self.paged:
            self.meter.pages(self.alloc.free_pages, self.alloc.used_pages)

    def _ids(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, dtype=np.int64),
                               device=self.device)

    def _cow_arrays(self, copies):
        return self._ids([c[0] for c in copies]), self._ids(
            [c[1] for c in copies])

    def _drain_shutdown(self, owners: dict) -> None:
        for ev, sink, _req, _dl in list(owners.values()):
            sink.append(RuntimeError("decoder shut down"))
            ev.set()
        if self._carry is not None:
            _p, _pad, _req, ev, sink, _dl = self._carry
            sink.append(RuntimeError("decoder shut down"))
            ev.set()
            self._carry = None
        while not self._pending.empty():
            _p, _pad, _req, ev, sink, _dl = self._pending.get_nowait()
            sink.append(RuntimeError("decoder shut down"))
            ev.set()

    def _next_pending(self):
        """FIFO head: the page-gated carry first, then the queue."""
        if self._carry is not None:
            item, self._carry = self._carry, None
            return item
        if not self._pending.empty():
            return self._pending.get_nowait()
        return None

    def _validate(self, item) -> bool:
        """A malformed row or an expired deadline fails only its caller,
        before it costs a prefill."""
        prompt, _pad, _req, ev, sink, dl = item
        if dl is not None and self.clock() >= dl:
            sink.append(DeadlineExceeded("deadline elapsed before admission"))
            ev.set()
            self._counters["deadline_canceled"] += 1
            return False
        if prompt.shape != (self.P,):
            sink.append(ValueError(
                f"padded row must have length {self.P}, got {prompt.shape}"))
            ev.set()
            return False
        return True

    def _expired_slots(self, owners: dict) -> list[int]:
        now = self.clock()
        return [s_ for s_, own in owners.items()
                if own[3] is not None and now >= own[3]]

    def _cancel_slot(self, owners: dict, slot: int) -> None:
        """Cancel one mid-decode slot: its waiter gets DeadlineExceeded,
        the slot and (paged) its pages go back to the pool."""
        ev, sink, _req, _dl = owners.pop(slot)
        sink.append(DeadlineExceeded("deadline exceeded during decode"))
        ev.set()
        self._free.append(slot)
        self._counters["deadline_canceled"] += 1
        if self.paged:
            self.alloc.free(slot)

    # -- scheduler loop ----------------------------------------------------

    def _loop(self) -> None:
        with torch.no_grad():     # grad mode is per thread
            self._run()

    def _run(self) -> None:
        owners: dict[int, tuple] = {}   # slot -> (ev, sink, req, deadline)

        def fail_all(err, batch=()):
            """Fail every waiter and rebuild the device state: a call
            that raised left it half updated."""
            for _p, _pad, _req, ev, sink, _dl in batch:
                sink.append(err)
                ev.set()
            for ev, sink, _req, _dl in list(owners.values()):
                sink.append(err)
                ev.set()
            owners.clear()
            self._free = list(range(self.S))
            if self.alloc is not None:
                self.alloc.reset()
            self.state = self._fresh_state()

        last_rem = np.zeros(self.S, np.int64)   # host mirror of remaining
        last_pos = np.zeros(self.S, np.int64)   # host mirror of pos
        while not self._stop:
            try:
                if self.paged:
                    self._admit_paged(owners, fail_all, last_rem, last_pos)
                else:
                    self._admit_dense(owners, fail_all, last_rem)
                # cancel expired slots at the tick boundary
                expired = self._expired_slots(owners)
                if expired:
                    self._op(_CLEAR, (), [np.asarray(expired, np.int64)])
                    for s_ in expired:
                        self._cancel_slot(owners, s_)
                        last_rem[s_] = 0
                    self._publish_pages()
                self._note_active(owners)
                if not owners:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                # FUSE ticks back to back when every active slot has a
                # full window left (none can finish inside it) and no
                # waiter could be admitted sooner by single ticks
                waiting = (self._carry is not None
                           or not self._pending.empty())
                fuse = ((not waiting or not self._free)
                        and all(int(last_rem[s_]) >= FUSE for s_ in owners))
                ticks = FUSE if fuse else 1
                pt = None
                if self.paged:
                    # hand out the pages the window crosses (reserved at
                    # admission) and copy-on-write its write range
                    for s_ in owners:
                        start = int(last_pos[s_])
                        self.alloc.append(s_, start + ticks)
                        copies = self.alloc.write_barrier(
                            s_, start, start + ticks)
                        if copies:
                            self.state = self._apply_copies(
                                self.state, *self._cow_arrays(copies))
                    pt = torch.as_tensor(self.alloc.table, device=self.device)
                t0, c0 = time.perf_counter(), COLLECTIVES.seconds
                if self.paged:
                    step = self._step_fused if fuse else self._step
                    self.state = step(self._params, self.state, pt)
                else:
                    self._op(_STEP, (int(fuse),))
                remaining = self.state.remaining.cpu().numpy()
                self._count_ticks(ticks, time.perf_counter() - t0,
                                  COLLECTIVES.seconds - c0)
                last_rem = remaining.copy()
                last_pos = self.state.pos.cpu().numpy().copy()
                out = None
                for s_ in list(owners):
                    if remaining[s_] <= 0:
                        if out is None:   # one readback per tick, lazily
                            out = self.state.out.cpu().numpy()
                        ev, sink, req, _dl = owners.pop(s_)
                        sink.extend(int(t) for t in out[s_][:req])
                        ev.set()
                        self._free.append(s_)
                        self._counters["completed"] += 1
                        if self.paged:
                            self.alloc.free(s_)
                self._publish_pages()
                self._note_active(owners)
            except Exception as e:    # a broken call: fail waiters, rebuild
                log.exception("slot-decoder loop failed")
                fail_all(e)
        self._drain_shutdown(owners)

    def _admit_dense(self, owners, fail_all, last_rem) -> None:
        """Idle decoder: prefill a batch of waiting prompts together
        (padded to the next size in _PREFILL_SIZES); otherwise admit at
        most one per tick, so a burst never stalls the decodes in
        flight."""
        if not (self._free and not self._pending.empty()):
            return
        want = 1 if owners else len(self._free)
        batch = []
        while len(batch) < want and not self._pending.empty():
            batch.append(self._pending.get_nowait())
        batch = [item for item in batch if self._validate(item)]
        if not batch:
            return
        k = next(n for n in self._PREFILL_SIZES if n >= len(batch))
        prompts = np.zeros((k, self.P), np.int64)
        pads = np.zeros((k,), np.int64)
        news = np.zeros((k,), np.int64)
        for i, (prompt, pad, req, _ev, _sink, _dl) in enumerate(batch):
            prompts[i] = prompt
            pads[i] = pad
            news[i] = req
        slots = [self._free.pop() for _ in range(len(batch))]
        # dummy rows (k > len(batch)) go to other free slots and are
        # cleared after the install; any real install later overwrites
        # the row whole
        dummies = self._free[:k - len(slots)]
        pad_slots = slots + dummies
        if len(pad_slots) != k:
            raise RuntimeError(f"prefill batch {k} for slots {pad_slots}")
        try:
            self._op(_ADMIT, (), [prompts, pads, np.asarray(pad_slots),
                                  news, np.asarray(dummies, np.int64)])
        except Exception as e:
            self._free.extend(slots)
            fail_all(e, batch)
            return
        self._counters["admitted"] += len(batch)
        self._counters["prefill_tokens_computed"] += len(batch) * self.P
        self._counters["prompt_tokens_submitted"] += len(batch) * self.P
        if self.meter:
            self.meter.prefill_tokens(len(batch) * self.P)
        for s_, (_prompt, _pad, req, ev, sink, dl) in zip(slots, batch):
            owners[s_] = (ev, sink, req, dl)
            last_rem[s_] = req

    def _admit_paged(self, owners, fail_all, last_rem, last_pos) -> None:
        """Per request: gate on pages (FIFO, no bypass), claim shared
        prefix pages, prefill only the uncached suffix into its pages."""
        want = 1 if owners else self.S
        admitted = 0
        while admitted < want and self._free:
            item = self._next_pending()
            if item is None:
                return
            if not self._validate(item):
                continue
            prompt, pad, req, ev, sink, dl = item
            row = [int(t) for t in prompt]
            total = self.P + req
            if not self.alloc.can_admit(row, pad, total):
                self._carry = item       # waits for pages; so does the rest
                return
            slot = self._free.pop()
            try:
                plan = self.alloc.admit(slot, row, pad, total)
                suffix = np.asarray(row[plan.compute_start:], np.int64)
                if plan.copies:
                    self.state = self._apply_copies(
                        self.state, *self._cow_arrays(plan.copies))
                self.state = self._paged_prefill_install(
                    self._params, self.state, self._ids(suffix[None, :]),
                    self._ids([plan.compute_start]),
                    torch.as_tensor(self.alloc.table[slot:slot + 1],
                                    device=self.device),
                    self._ids([pad]), slot, req)
            except Exception as e:
                # the slot's pages go back before the slot id does:
                # recycling the slot first would leak every page its
                # admission claimed (free() is a no-op if admit raised)
                self.alloc.free(slot)
                self._free.append(slot)
                fail_all(e, [item])
                return
            owners[slot] = (ev, sink, req, dl)
            last_rem[slot] = req
            last_pos[slot] = self.P
            self._counters["admitted"] += 1
            self._counters["prefill_tokens_computed"] += len(suffix)
            self._counters["prompt_tokens_submitted"] += self.P
            if self.meter:
                self.meter.prefill_tokens(len(suffix))
                self.meter.prefix_hits(plan.shared_pages)
            self._publish_pages()
            admitted += 1

    # -- speculative lockstep loop ---------------------------------------

    def _row_install(self, big: dict, row: dict, slot: int) -> None:
        for name, t in big.items():
            t[slot] = row[name][0].to(t.dtype)

    def _spec_admit(self, prompt, pad: int, slot: int, plan=None) -> int:
        """Prefill the target (dense: a 1-row cache installed into the
        slot's row; paged: the uncached suffix into its pages) and the
        draft (a 1-row cache into its row); returns the first token, the
        target's greedy pick after the prompt."""
        row = self._ids(prompt[None, :])
        pad_t = self._ids([pad])
        if self.paged:
            if plan.copies:
                copy_pages(self.t_cache, *self._cow_arrays(plan.copies))
            logits = self.model.apply(
                self._params, row[:, plan.compute_start:],
                decode_index=self._ids([plan.compute_start]), pad_len=pad_t,
                page_table=torch.as_tensor(self.alloc.table[slot:slot + 1],
                                           device=self.device),
                cache=self.t_cache)[:, -1]
        else:
            tc1, logits = prefill_scan(self.model, self._params,
                                       init_cache(self.model, 1), row, pad_t)
            self._row_install(self.t_cache, tc1, slot)
        dc1, _ = prefill_scan(self.draft, self._d_params,
                              init_cache(self.draft, 1), row, pad_t)
        self._row_install(self.d_cache, dc1, slot)
        return int(torch.argmax(logits[0], dim=-1))

    def _loop_spec(self) -> None:
        with torch.no_grad():
            self._run_spec()

    def _run_spec(self) -> None:
        k = self.draft_k
        k1 = k + 1
        owners: dict[int, tuple] = {}    # slot -> (ev, sink, req, deadline)
        out_h: dict[int, list] = {}      # slot -> emitted tokens
        ebuf: dict[int, list] = {}       # slot -> last round's emissions
        pos_h = np.zeros(self.S, np.int64)   # position of each slot's cur
        rem_h = np.zeros(self.S, np.int64)
        pads_h = np.zeros(self.S, np.int64)

        def fail_all(err, batch=()):
            for _p, _pad, _req, ev, sink, _dl in batch:
                sink.append(err)
                ev.set()
            for ev, sink, _req, _dl in list(owners.values()):
                sink.append(err)
                ev.set()
            owners.clear()
            out_h.clear()
            ebuf.clear()
            self._free = list(range(self.S))
            if self.alloc is not None:
                self.alloc.reset()
            self.t_cache = self._fresh_cache()
            self.d_cache = init_cache(self.draft, self.S)

        def complete(slot: int) -> None:
            ev, sink, _req, _dl = owners.pop(slot)
            sink.extend(out_h.pop(slot))
            ebuf.pop(slot, None)
            ev.set()
            self._free.append(slot)
            self._counters["completed"] += 1
            if self.paged:
                self.alloc.free(slot)
            self._publish_pages()

        def admit() -> None:
            want = 1 if owners else self.S
            admitted = 0
            while admitted < want and self._free:
                item = self._next_pending()
                if item is None:
                    return
                if not self._validate(item):
                    continue
                prompt, pad, req, ev, sink, dl = item
                row = [int(t) for t in prompt]
                total = self.P + req + k
                if self.paged and not self.alloc.can_admit(row, pad, total):
                    self._carry = item
                    return
                slot = self._free.pop()
                try:
                    plan = (self.alloc.admit(slot, row, pad, total)
                            if self.paged else None)
                    first = self._spec_admit(prompt, pad, slot, plan)
                except Exception as e:
                    if self.paged:
                        self.alloc.free(slot)
                    self._free.append(slot)
                    fail_all(e, [item])
                    return
                n_pref = self.P - plan.compute_start if plan else self.P
                owners[slot] = (ev, sink, req, dl)
                out_h[slot] = [first]
                ebuf[slot] = [first]
                pos_h[slot] = self.P
                rem_h[slot] = req - 1
                pads_h[slot] = pad
                self._counters["admitted"] += 1
                self._counters["prefill_tokens_computed"] += n_pref
                self._counters["prompt_tokens_submitted"] += self.P
                if self.meter:
                    self.meter.prefill_tokens(n_pref)
                    if self.paged:
                        self.meter.prefix_hits(plan.shared_pages)
                self._publish_pages()
                if rem_h[slot] <= 0:
                    complete(slot)     # the prefill's token was the budget
                else:
                    admitted += 1

        while not self._stop:
            try:
                admit()
                # a cancelled slot's mirrors are dropped: later rounds
                # never emit for it, its cache rows are dead
                expired = self._expired_slots(owners)
                for s_ in expired:
                    self._cancel_slot(owners, s_)
                    out_h.pop(s_, None)
                    ebuf.pop(s_, None)
                    rem_h[s_] = 0
                if expired:
                    self._publish_pages()
                self._note_active(owners)
                if not owners:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                # one propose/verify round over every busy slot
                order = sorted(owners)
                emitted = np.zeros((self.S, k1), np.int64)
                starts = np.zeros(self.S, np.int64)
                elen = np.ones(self.S, np.int64)
                curv = np.zeros(self.S, np.int64)
                for s_ in order:
                    e = ebuf[s_]
                    emitted[s_, :len(e)] = e
                    starts[s_] = pos_h[s_] - len(e) + 1
                    elen[s_] = len(e)
                    curv[s_] = e[-1]
                    if self.paged:
                        # the verify writes positions pos .. pos + k
                        self.alloc.append(s_, int(pos_h[s_]) + k1)
                        copies = self.alloc.write_barrier(
                            s_, int(pos_h[s_]), int(pos_h[s_]) + k1)
                        if copies:
                            copy_pages(self.t_cache,
                                       *self._cow_arrays(copies))
                pads_dev = self._ids(pads_h)
                props = lockstep_propose(
                    self.draft, self._d_params, self.d_cache,
                    self._ids(emitted), self._ids(starts), self._ids(elen),
                    k=k, pad_len=pads_dev)
                chunk = torch.cat([self._ids(curv)[:, None], props], dim=1)
                pt = (torch.as_tensor(self.alloc.table, device=self.device)
                      if self.paged else None)
                y = lockstep_verify(self.model, self._params, self.t_cache,
                                    chunk, self._ids(pos_h), pad_len=pads_dev,
                                    page_table=pt)
                props_h = props.cpu().numpy()
                y_h = y.cpu().numpy()
                round_accepted = 0
                for s_ in order:
                    a = greedy_accept(props_h[s_], y_h[s_], k)
                    emit = [int(t) for t in props_h[s_][:a]]
                    emit.append(int(y_h[s_][a]))
                    take = min(len(emit), int(rem_h[s_]))
                    emit = emit[:take]
                    out_h[s_].extend(emit)
                    ebuf[s_] = emit
                    pos_h[s_] += take
                    rem_h[s_] -= take
                    round_accepted += min(a, take)
                    self._counters["spec_rounds"] += 1
                    self._counters["spec_tokens_emitted"] += take
                    self._counters["spec_tokens_accepted"] += min(a, take)
                    self._counters["spec_drafted"] += k
                    if rem_h[s_] <= 0:
                        complete(s_)
                if self.meter:
                    self.meter.spec_round(len(order), round_accepted)
                self._note_active(owners)
            except Exception as e:     # a broken call: fail waiters, rebuild
                log.exception("speculative slot-decoder loop failed")
                fail_all(e)
        self._drain_shutdown(owners)
