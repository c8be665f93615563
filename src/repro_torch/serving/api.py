"""Session-centric serving API: fork() handles + streaming (port of
``repro/serving/api.py``, DESIGN.md §11).

The paper's headline primitive is OS-style ``fork()`` with copy-on-write,
and this module is its client-facing surface.  Nothing outside
``repro/serving`` needs to construct :class:`~repro_torch.serving.engine.Request`
objects or busy-poll ``engine.step()`` any more:

  * :class:`ForkServer` wraps an :class:`~repro_torch.serving.engine.Engine` and
    owns the step loop: ``poll()`` advances the engine one step and
    dispatches :class:`TokenEvent` s to live handles.
  * :class:`AgentSession` (``server.session(context_tokens)``) prefills a
    shared context ONCE and holds a radix *pin* for its whole lifetime —
    the context is immune to eviction while the session is live, so every
    later ``fork()`` hits it (pins are distinct from the transient
    per-request locks admission takes; see ``RadixTree.pin``).
  * ``session.fork(adapter_id, instruction_tokens, sampling)`` returns a
    :class:`GenerationHandle` whose ``stream()`` yields tokens as decode
    steps produce them and whose ``result()`` blocks (pumping the engine)
    until the request finishes.
  * :class:`~repro_torch.serving.sampling.SamplingParams` selects greedy argmax
    (default — bit-for-bit the seed behaviour) or seeded
    temperature/top-k/top-p sampling, executed on the executor's device.

Event semantics: the engine's convention generates ``max_new_tokens + 1``
tokens and discards the trailing one (its KV is never written), and a stop
token ends generation without being returned.  Both reduce to the same
rule — the definitive output is always ``req.output[:-1]`` — so the stream
emits token *i* once token *i+1* exists (a one-step lag) and therefore
yields exactly ``result().tokens``, incrementally, followed by one terminal
event carrying the finish reason.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Sequence

from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.sampling import GREEDY, SamplingParams

__all__ = ["ForkServer", "AgentSession", "GenerationHandle", "TokenEvent",
           "RequestOutput", "SamplingParams", "GREEDY"]


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One unit of streaming progress for a request."""

    rid: int
    index: int                   # position in the generated sequence
    token: Optional[int]         # None on the terminal event
    finished: bool = False
    finish_reason: str = ""      # stop | length | rejected | stalled |
                                 # timeout
    ts: float = 0.0              # when the token was committed (epoch s);
                                 # a multi-token speculative commit emits
                                 # one event per token with interpolated
                                 # stamps, so TPOT stays honest


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """Final result of one generation request."""

    rid: int
    adapter_id: int
    tokens: List[int]
    finish_reason: str           # stop | length | rejected | stalled |
                                 # timeout
    error: str                   # non-empty for rejected/stalled/timeout
    metrics: Dict[str, float]    # per-request counters (prefill, latency)
    tenant: str = "default"      # tenant billed for this request (§15)
    retry_after_s: float = 0.0   # overload-shed backoff hint (HTTP 429)


class GenerationHandle:
    """Handle to one in-flight generation (returned by ``fork()``).

    ``stream()`` yields :class:`TokenEvent` s incrementally;
    ``result()`` pumps the server until the request completes.  Both may
    be used on the same handle (events are consumed exactly once by
    whichever iterator pops them first; ``result()`` never consumes the
    event queue).
    """

    def __init__(self, server: "ForkServer", req: Request):
        self._server = server
        self._req = req
        self._queue: Deque[TokenEvent] = deque()
        self._emitted = 0
        self._terminal_sent = False

    # ------------------------------------------------------------- status
    @property
    def rid(self) -> int:
        return self._req.rid

    @property
    def adapter_id(self) -> int:
        return self._req.adapter_id

    @property
    def done(self) -> bool:
        return self._req.state == "done"

    # ------------------------------------------------------------ events
    def _drain_new(self) -> List[TokenEvent]:
        """Called by ``ForkServer.poll``: turn engine progress since the
        last poll into events.  Emits token *i* once token *i+1* exists
        (lag-one — see module docstring), so the stream always equals the
        final ``result().tokens``."""
        req = self._req
        out: List[TokenEvent] = []
        limit = max(0, len(req.output) - 1)
        times = req.token_times
        for i in range(self._emitted, limit):
            out.append(TokenEvent(rid=req.rid, index=i,
                                  token=req.output[i],
                                  ts=times[i] if i < len(times) else 0.0))
        self._emitted = max(self._emitted, limit)
        if req.state == "done" and not self._terminal_sent:
            out.append(TokenEvent(rid=req.rid, index=self._emitted,
                                  token=None, finished=True,
                                  finish_reason=req.finish_reason,
                                  ts=req.finished_at))
            self._terminal_sent = True
        self._queue.extend(out)
        return out

    def stream(self) -> Iterator[TokenEvent]:
        """Yield this request's TokenEvents as the engine produces them,
        pumping ``server.poll()`` whenever none are pending.  Ends after
        the terminal (``finished=True``) event."""
        while True:
            while self._queue:
                ev = self._queue.popleft()
                yield ev
                if ev.finished:
                    return
            if self._terminal_sent:
                return               # terminal already consumed elsewhere
            self._server.poll()

    def result(self) -> RequestOutput:
        """Pump the server until this request finishes; return its output.
        Does not consume the event queue — a concurrent ``stream()`` still
        sees every event."""
        req = self._req
        while req.state != "done":
            self._server.poll()
        if not self._terminal_sent:
            self._drain_new()
        tokens = list(req.output[:-1]) if req.output else []
        latency = max(0.0, req.finished_at - req.arrival) \
            if req.finished_at else 0.0
        # per-request latency breakdown (DESIGN.md §14): TTFT from arrival
        # to the first sampled token, TPOT the per-token mean after it
        ttft_s = max(0.0, req.first_token_at - req.arrival) \
            if req.first_token_at else 0.0
        # TPOT from the per-token commit stamps when available (multi-token
        # speculative commits interpolate within the step); fall back to
        # span/(n-1) for requests without stamps
        if len(req.token_times) >= 2:
            tpot_s = ((req.token_times[-1] - req.token_times[0]) /
                      (len(req.token_times) - 1))
        else:
            tpot_s = (max(0.0, req.finished_at - req.first_token_at) /
                      max(1, len(req.output) - 1)) if req.first_token_at \
                else 0.0
        return RequestOutput(
            rid=req.rid, adapter_id=req.adapter_id, tokens=tokens,
            finish_reason=req.finish_reason or "length", error=req.error,
            tenant=req.tenant, retry_after_s=req.retry_after_s,
            metrics={"prompt_tokens": len(req.prompt),
                     "prefilled_tokens": req.prefilled_tokens,
                     "prefill_share": req.prefill_share,
                     "kv_len": req.kv_len,
                     "latency_s": latency,
                     "ttft_ms": ttft_s * 1e3,
                     "tpot_ms": tpot_s * 1e3,
                     "spec_proposed": req.spec_proposed,
                     "spec_accepted": req.spec_accepted})


class AgentSession:
    """A pinned shared context plus the forks spawned from it.

    Created via :meth:`ForkServer.session` — the context is prefilled once
    (a context-only request) and its radix path pinned for the session's
    lifetime, so concurrent load can never evict it out from under the
    agent tree.  ``close()`` (or use as a context manager) drops the pin.
    """

    def __init__(self, server: "ForkServer", context: Sequence[int],
                 adapter_id: int, pin_handle, tenant: str = "default"):
        self._server = server
        self.context = list(context)
        self.adapter_id = adapter_id
        self.tenant = tenant
        self._pin = pin_handle
        self._closed = False
        self.forks = 0

    @property
    def alive(self) -> bool:
        return not self._closed

    def fork(self, adapter_id: int, instruction_tokens: Sequence[int],
             sampling: Optional[SamplingParams] = None,
             deadline_s: float = 0.0) -> GenerationHandle:
        """Fork the pinned context: new request = context ‖ instruction,
        served under ``adapter_id`` with CoW cache inheritance.  The fork
        bills against the session's tenant."""
        if self._closed:
            raise RuntimeError("fork() on a closed AgentSession")
        self.forks += 1
        return self._server.generate(
            adapter_id, self.context + list(instruction_tokens),
            sampling=sampling, tenant=self.tenant, deadline_s=deadline_s)

    def close(self) -> None:
        """Drop the session pin; the context becomes evictable again."""
        if not self._closed:
            self._closed = True
            self._server.engine.unpin(self._pin)
            self._server._sessions.discard(id(self))

    def __enter__(self) -> "AgentSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ForkServer:
    """Client-facing serving frontend over the ForkKV :class:`Engine`.

    One ``poll()`` call advances the engine one step (admission + at most
    one batched prefill call + one decode round) and dispatches TokenEvents to
    every live handle — the single pump replacing the per-caller busy
    loops of the seed (``WorkflowDriver._run_request`` et al.).
    """

    def __init__(self, cfg, params, lora, sc, device=None):
        """``device=None`` serves on the CUDA device and raises when there
        is none; pass ``device="cpu"`` to serve with the plain versions."""
        self.engine = Engine(cfg, params, lora, sc, device=device)
        self._init_state()

    @classmethod
    def from_engine(cls, engine: Engine) -> "ForkServer":
        srv = cls.__new__(cls)
        srv.engine = engine
        srv._init_state()
        return srv

    def _init_state(self) -> None:
        self._rids = itertools.count(1)
        self._handles: Dict[int, GenerationHandle] = {}
        self._sessions = set()
        self.events_dispatched = 0

    # ---------------------------------------------------------- sessions
    def session(self, context_tokens: Sequence[int],
                adapter_id: int = 0,
                tenant: str = "default") -> AgentSession:
        """Prefill ``context_tokens`` once and pin the result for the
        session's lifetime.  Synchronous: pumps the engine until the
        context cache is built (concurrent handles keep streaming).
        ``tenant`` owns the session: forks bill against it and the pinned
        pages count toward its ``tenant_max_pinned_pages`` budget."""
        req = Request(rid=next(self._rids), adapter_id=adapter_id,
                      prompt=list(context_tokens), max_new_tokens=0,
                      is_context=True, arrival=time.time(), tenant=tenant)
        self.engine.submit(req)
        while req.state != "done":
            self.poll()
        if req.error:
            raise RuntimeError(f"session context failed: {req.error}")
        pin = self.engine.pin_prefix(req.prompt, adapter_id, tenant=tenant)
        sess = AgentSession(self, context_tokens, adapter_id, pin,
                            tenant=tenant)
        self._sessions.add(id(sess))
        return sess

    # --------------------------------------------------------- generation
    def generate(self, adapter_id: int, prompt_tokens: Sequence[int],
                 sampling: Optional[SamplingParams] = None,
                 tenant: str = "default", deadline_s: float = 0.0
                 ) -> GenerationHandle:
        """Submit a generation request; returns immediately with a handle.
        (Session-less entry point — ``session.fork`` builds on it.)
        ``deadline_s`` bounds QUEUEING time: a request still waiting that
        long after arrival finishes with ``finish_reason="timeout"``
        instead of waiting forever (DESIGN.md §15)."""
        sp = sampling if sampling is not None else GREEDY
        req = Request(rid=next(self._rids), adapter_id=adapter_id,
                      prompt=list(prompt_tokens),
                      max_new_tokens=sp.max_new_tokens, sampling=sp,
                      arrival=time.time(), tenant=tenant,
                      deadline_s=deadline_s)
        self.engine.submit(req)
        handle = GenerationHandle(self, req)
        self._handles[req.rid] = handle
        return handle

    # ``submit`` is the historical name for the session-less entry point;
    # keep it as an alias so callers reading the paper-facing docs
    # (``ForkServer.submit(..., deadline_s=...)``) land on generate().
    submit = generate

    # --------------------------------------------------------------- pump
    def poll(self) -> List[TokenEvent]:
        """Advance the engine one step and dispatch new TokenEvents to
        their handles.  Returns the events dispatched by this call."""
        eng = self.engine
        if eng.waiting or eng.running:
            eng.step()
        events: List[TokenEvent] = []
        for rid, handle in list(self._handles.items()):
            events.extend(handle._drain_new())
            if handle._terminal_sent:
                del self._handles[rid]     # handle keeps its own queue
        self.events_dispatched += len(events)
        return events

    def wait(self, handles: Optional[Sequence[GenerationHandle]] = None
             ) -> List[RequestOutput]:
        """Pump until the given handles (default: everything in flight)
        complete; returns their outputs in order."""
        if handles is None:
            handles = list(self._handles.values())
        while any(not h.done for h in handles):
            self.poll()
        return [h.result() for h in handles]

    def run(self, max_polls: int = 1_000_000) -> None:
        """Pump until the engine is idle."""
        for _ in range(max_polls):
            if not self.engine.waiting and not self.engine.running:
                break
            self.poll()

    # -------------------------------------------------------------- drain
    def drain(self) -> None:
        """Stop admitting new work (DESIGN.md §17): every request still in
        ``waiting`` finishes with ``finish_reason="draining"`` on the next
        poll; in-flight requests run to completion.  Idempotent."""
        self.engine.drain()

    @property
    def drained(self) -> bool:
        """True once draining AND nothing is waiting or running."""
        return self.engine.drained

    # ------------------------------------------------------------ metrics
    def metrics(self) -> Dict:
        m = self.engine.metrics()
        m["events_dispatched"] = self.events_dispatched
        m["live_sessions"] = len(self._sessions)
        return m
