"""Async HTTP serving frontend: SSE token streaming over the ForkServer
(port of ``repro/serving/frontend.py``, DESIGN.md §15).

The single-pump design of :mod:`repro_torch.serving.api` (§11) was built for
exactly this: ONE thread owns the engine and calls ``server.poll()``;
everything else talks to it through queues.  The frontend maps external
HTTP traffic onto that pump:

  * **pump thread** — the only thread that touches the engine.  It
    executes queued *ops* (submit / create session / fork / metrics),
    polls the server whenever work is in flight, and forwards each
    handle's :class:`~repro_torch.serving.api.TokenEvent` s into per-request
    ``asyncio.Queue`` s via ``loop.call_soon_threadsafe``.  It first binds
    itself to the engine's CUDA device (``PagedExecutor.bind_thread``): a
    new thread starts on the default device, not the one the server was
    built on.
  * **asyncio event loop** — stdlib ``asyncio`` streams (no third-party
    HTTP dependency): parses requests, runs ops on the pump thread via
    ``asyncio.wrap_future``, and streams Server-Sent Events as tokens
    arrive.

API (JSON bodies; token ids, not text — the repo is tokenizer-free):

  ``POST /v1/completions``
      ``{"prompt": [ints], "adapter_id": 0, "tenant": "default",
      "max_new_tokens": 16, "temperature": 0.0, "top_k": 0,
      "top_p": 1.0, "seed": 0, "deadline_s": 0, "stream": false}``.
      ``stream=true`` responds ``text/event-stream``: one
      ``data: {"token": t, "index": i}`` event per token, then a
      terminal ``data: {"finished": true, "finish_reason": ...,
      "tokens": [...], "metrics": {...}}`` event.  ``stream=false``
      responds with the terminal JSON directly.
  ``POST /v1/sessions``
      ``{"context": [ints], "adapter_id": 0, "tenant": "default"}`` —
      prefills + pins the shared context (an :class:`AgentSession`),
      returns ``{"session_id": "..."}``.
  ``POST /v1/sessions/{id}/fork``
      completion body minus ``prompt`` plus ``"instruction": [ints]`` —
      forks the pinned context (CoW cache inheritance), same streaming
      semantics as completions.
  ``DELETE /v1/sessions/{id}``
      drops the session pin.
  ``GET /v1/metrics``
      ``Engine.metrics()`` as JSON (queue depth, admission waits,
      per-tenant counters, cache/tier/kernel metrics).
  ``GET /healthz``
      health states (DESIGN.md §17): ``healthy`` / ``overloaded`` (200),
      ``draining`` / ``stuck`` (503 — take the replica out of rotation).
  ``POST /v1/drain``
      graceful drain: stop admission (new work → 503 + Retry-After),
      finish everything in flight.  ``SIGTERM`` in ``launch/serve.py``
      triggers the same path.

Status mapping: admission rejects a request by FINISHING it (the engine
never throws at a tenant), and the frontend translates the terminal
state: overload shed → ``429`` with a ``Retry-After`` header (the
policy's deterministic backoff hint), impossible request (too long) →
``400``, queueing deadline expired → ``504``, stall-detection failure →
``503``.  A stream that already delivered tokens cannot change its
status retroactively — the terminal SSE event carries the finish reason
instead (standard SSE practice).

:class:`ForkClient` is the matching stdlib ``http.client`` client used
by the tests, ``scripts/smoke_torch.sh``'s drain stage and
``chip_smoke.py``.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import http.client
import itertools
import json
import math
import queue
import random
import threading
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional, Set,
                    Tuple)

from repro_torch.serving.api import AgentSession, ForkServer, \
    GenerationHandle
from repro_torch.serving.sampling import SamplingParams

__all__ = ["HttpFrontend", "ForkClient"]


# every key a completion/fork body may carry; anything else is a typo the
# caller should hear about as a 400, not silently-ignored greedy sampling
_KNOWN_KEYS = frozenset({
    "prompt", "instruction", "adapter_id", "tenant", "deadline_s", "stream",
    "temperature", "top_k", "top_p", "seed", "max_new_tokens",
    "stop_token_ids", "speculate", "spec_k"})


def _sampling_from(body: Dict) -> SamplingParams:
    unknown = sorted(set(body) - _KNOWN_KEYS)
    if unknown:
        raise ValueError(f"unknown sampling key(s): {', '.join(unknown)}")
    spec = body.get("speculate")          # absent/None = engine default
    return SamplingParams(
        temperature=float(body.get("temperature", 0.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        seed=int(body.get("seed", 0)),
        max_new_tokens=int(body.get("max_new_tokens", 16)),
        stop_token_ids=tuple(body.get("stop_token_ids", ())),
        speculate=None if spec is None else bool(spec),
        spec_k=int(body.get("spec_k", 0)))


def _status_for(finish_reason: str, retry_after_s: float) -> int:
    """HTTP status for a request that finished WITHOUT producing output
    (see module docstring)."""
    if finish_reason == "rejected":
        return 429 if retry_after_s > 0 else 400
    if finish_reason == "timeout":
        return 504
    if finish_reason in ("stalled", "draining"):
        return 503
    if finish_reason == "error":
        return 500
    return 200


@dataclasses.dataclass
class _Stream:
    """Pump-side bridge: one generation handle feeding one asyncio queue."""

    handle: GenerationHandle
    aq: asyncio.Queue
    loop: asyncio.AbstractEventLoop


class HttpFrontend:
    """HTTP gateway over one :class:`ForkServer` (DESIGN.md §15).

    ``serve_forever()`` runs in the calling thread (Ctrl-C to stop);
    ``start_background()`` / ``shutdown()`` run it in a daemon thread for
    tests and embedding.  ``port=0`` binds an ephemeral port, published
    as ``self.port`` once the listener is up.  ``warm_up()`` before
    either serves one request first, so that a cold server on a card
    builds its kernels before a client's request is in flight.
    """

    def __init__(self, server: ForkServer, host: str = "127.0.0.1",
                 port: int = 0):
        self.server = server
        self.host = host
        self.port = port
        self._ops: "queue.Queue[Callable[[], None]]" = queue.Queue()
        self._streams: Dict[int, _Stream] = {}
        # requests whose HTTP response is not fully written yet: a stream
        # leaves ``_streams`` once its terminal event is queued to the
        # event loop, before the loop has written it
        self._undelivered: Set[int] = set()
        self._sessions: Dict[str, AgentSession] = {}
        self._session_ids = itertools.count(1)
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._pump_thread: Optional[threading.Thread] = None
        self._watchdog_thread: Optional[threading.Thread] = None
        self._wd_tripped = False
        self._draining = False
        self.requests_served = 0

    # ------------------------------------------------------------ lifecycle
    def warm_up(self) -> None:
        """Serve one short greedy request to its end on the calling thread
        (the one that built the server), before the front end starts: on a
        CUDA device the first step builds the kernels, tens of seconds that
        the watchdog would otherwise count as a stall of the first client's
        request.  The request counts in the engine's metrics like any
        other."""
        if self._pump_thread is not None:
            raise RuntimeError("warm_up runs before the frontend starts")
        eng = self.server.engine
        prompt = [t % eng.cfg.vocab_size for t in range(1, eng.sc.page_size
                                                        + 2)]
        self.server.generate(0, prompt,
                             SamplingParams(max_new_tokens=2)).result()

    def serve_forever(self) -> None:
        asyncio.run(self._amain())

    def start_background(self) -> "HttpFrontend":
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True, name="forkkv-http")
        self._thread.start()
        if not self._ready.wait(timeout=30):
            raise RuntimeError("HTTP frontend failed to start")
        return self

    def shutdown(self) -> None:
        self._stop.set()
        if self._loop is not None:
            with contextlib.suppress(RuntimeError):
                self._loop.call_soon_threadsafe(lambda: None)  # wake loop
        if self._thread is not None:
            self._thread.join(timeout=10)

    # --------------------------------------------------------------- drain
    def begin_drain(self) -> None:
        """Stop admitting new work; in-flight requests run to completion
        (DESIGN.md §17).  Non-blocking and signal-safe: the frontend flag
        flips immediately (new HTTP requests get 503) and the engine-side
        drain runs as a queued pump op (``queue.Queue.put`` is safe from
        a signal handler).  Idempotent."""
        if self._draining:
            return
        self._draining = True
        self._ops.put(self.server.drain)

    @property
    def drained(self) -> bool:
        """True once draining AND the engine is empty AND every SSE
        stream has delivered its terminal event."""
        return self._draining and self.server.engine.drained \
            and not self._streams and not self._undelivered

    async def _amain(self) -> None:
        self._loop = asyncio.get_running_loop()
        srv = await asyncio.start_server(self._handle_conn, self.host,
                                         self.port)
        self.port = srv.sockets[0].getsockname()[1]
        self._pump_thread = threading.Thread(target=self._pump, daemon=True,
                                             name="forkkv-pump")
        self._pump_thread.start()
        if self.server.engine.sc.watchdog_s > 0:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog, daemon=True, name="forkkv-watchdog")
            self._watchdog_thread.start()
        self._ready.set()
        try:
            async with srv:
                while not self._stop.is_set():
                    await asyncio.sleep(0.05)
        finally:
            self._stop.set()
            self._pump_thread.join(timeout=10)

    def _watchdog(self) -> None:
        """Stuck-pump detector (DESIGN.md §17): with work in flight, the
        step loop should stamp ``engine.last_step_at`` continuously; a
        gap beyond ``watchdog_s`` means the pump wedged (deadlocked op,
        hung device call).  One trip per stall episode — the counter is
        a health signal surfaced via ``/healthz`` and metrics, not a
        kill switch (the operator decides whether to restart)."""
        eng = self.server.engine
        limit = eng.sc.watchdog_s
        while not self._stop.wait(max(0.01, limit / 4)):
            busy = bool(eng.waiting or eng.running)
            stalled = busy and (time.time() - eng.last_step_at) > limit
            if stalled and not self._wd_tripped:
                self._wd_tripped = True
                eng.watchdog_trips += 1
            elif not stalled:
                self._wd_tripped = False

    # ------------------------------------------------------------ pump side
    # The pump thread is the ONLY thread that touches the ForkServer /
    # Engine (they are single-threaded by design, §11).  Ops are plain
    # closures; results travel back on concurrent.futures.Futures.
    def _pump(self) -> None:
        self.server.engine.executor.bind_thread()
        while not self._stop.is_set():
            busy = False
            while True:
                try:
                    op = self._ops.get_nowait()
                except queue.Empty:
                    break
                op()
                busy = True
            eng = self.server.engine
            if eng.waiting or eng.running:
                self.server.poll()
                busy = True
            self._forward_events()
            if not busy:
                time.sleep(0.001)

    def _forward_events(self) -> None:
        done: List[int] = []
        for rid, st in self._streams.items():
            while st.handle._queue:
                ev = st.handle._queue.popleft()
                payload = {"rid": ev.rid, "index": ev.index,
                           "token": ev.token, "finished": ev.finished,
                           "finish_reason": ev.finish_reason,
                           "ts": ev.ts}
                st.loop.call_soon_threadsafe(st.aq.put_nowait, payload)
                if ev.finished:
                    done.append(rid)
        for rid in done:
            del self._streams[rid]

    async def _call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` on the pump thread; await its result."""
        fut: "concurrent.futures.Future[Any]" = concurrent.futures.Future()

        def op() -> None:
            try:
                fut.set_result(fn())
            except BaseException as exc:   # travel back to the async side
                fut.set_exception(exc)

        self._ops.put(op)
        return await asyncio.wrap_future(fut)

    # --------------------------------------------------------- HTTP server
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), timeout=60)
            if not line:
                return
            try:
                method, target, _ = line.decode("latin1").split(None, 2)
            except ValueError:
                await self._respond(writer, 400, {"error": "bad request"})
                return
            headers: Dict[str, str] = {}
            while True:
                hline = await reader.readline()
                if hline in (b"\r\n", b"\n", b""):
                    break
                k, _, v = hline.decode("latin1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body: Dict = {}
            n = int(headers.get("content-length", "0") or 0)
            if n:
                raw = await reader.readexactly(n)
                try:
                    body = json.loads(raw)
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except (ValueError, UnicodeDecodeError):
                    # covers JSONDecodeError (a ValueError) AND invalid
                    # utf-8 — either way the caller hears 400, not a
                    # dropped connection (§17 satellite)
                    await self._respond(writer, 400,
                                        {"error": "invalid JSON body"})
                    return
            self.requests_served += 1
            await self._route(method.upper(), target.split("?")[0],
                              body, writer)
        except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                ConnectionError):
            pass
        finally:
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    def _health(self) -> Tuple[int, Dict]:
        """Health snapshot (DESIGN.md §17).  Reads engine counters
        directly (benign racy reads — scalars under the GIL) so health
        stays answerable even when the pump is wedged, which is exactly
        when an orchestrator needs the answer.  States: ``healthy`` |
        ``overloaded`` (still 200 — serving, but shedding likely) |
        ``draining`` | ``stuck`` (503 — take it out of rotation)."""
        eng = self.server.engine
        wd = eng.sc.watchdog_s
        busy = bool(eng.waiting or eng.running)
        stuck = wd > 0 and busy and \
            (time.time() - eng.last_step_at) > wd
        if self._draining:
            state, status = "draining", 503
        elif stuck:
            state, status = "stuck", 503
        elif len(eng.waiting) > 2 * max(1, eng.sc.max_batch):
            state, status = "overloaded", 200
        else:
            state, status = "healthy", 200
        return status, {"ok": status == 200, "state": state,
                        "waiting": len(eng.waiting),
                        "running": len(eng.running),
                        "drained": self.drained,
                        "watchdog_trips": eng.watchdog_trips}

    async def _route(self, method: str, path: str, body: Dict,
                     writer: asyncio.StreamWriter) -> None:
        if method == "GET" and path == "/healthz":
            status, doc = self._health()
            await self._respond(writer, status, doc)
        elif method == "POST" and path == "/v1/drain":
            self.begin_drain()
            await self._respond(writer, 200,
                                {"draining": True, "drained": self.drained})
        elif method == "GET" and path == "/v1/metrics":
            m = await self._call(self.server.metrics)
            m["http_sessions"] = len(self._sessions)
            m["http_requests_served"] = self.requests_served
            await self._respond(writer, 200, m)
        elif method == "POST" and path == "/v1/completions":
            await self._completion(body, writer)
        elif method == "POST" and path == "/v1/sessions":
            await self._create_session(body, writer)
        elif method == "POST" and path.startswith("/v1/sessions/") and \
                path.endswith("/fork"):
            sid = path[len("/v1/sessions/"):-len("/fork")]
            await self._fork(sid, body, writer)
        elif method == "DELETE" and path.startswith("/v1/sessions/"):
            sid = path[len("/v1/sessions/"):]
            await self._close_session(sid, writer)
        else:
            await self._respond(writer, 404,
                                {"error": f"no route {method} {path}"})

    # ----------------------------------------------------------- endpoints
    def _register(self, handle: GenerationHandle,
                  aq: asyncio.Queue) -> None:
        """Pump-side: track a handle for event forwarding.  MUST run on
        the pump thread (inside the op that created the handle) so no
        event can slip between creation and registration."""
        self._streams[handle.rid] = _Stream(handle, aq,
                                            self._loop)  # type: ignore
        self._undelivered.add(handle.rid)

    async def _refuse_if_draining(self,
                                  writer: asyncio.StreamWriter) -> bool:
        """Drain guard for work-submitting endpoints: 503 + Retry-After
        so well-behaved clients fail over to another replica instead of
        queueing behind a server that will never admit them."""
        if self._draining:
            await self._respond(writer, 503,
                                {"error": "server is draining",
                                 "finish_reason": "draining"},
                                extra_headers={"Retry-After": "1"})
            return True
        return False

    async def _completion(self, body: Dict,
                          writer: asyncio.StreamWriter) -> None:
        if await self._refuse_if_draining(writer):
            return
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or \
                not all(isinstance(t, int) for t in prompt):
            await self._respond(writer, 400,
                                {"error": "prompt must be a list of ints"})
            return
        try:
            sp = _sampling_from(body)
        except ValueError as exc:
            await self._respond(writer, 400, {"error": str(exc)})
            return
        aq: asyncio.Queue = asyncio.Queue()

        def op() -> GenerationHandle:
            h = self.server.generate(
                int(body.get("adapter_id", 0)), prompt, sampling=sp,
                tenant=str(body.get("tenant", "default")),
                deadline_s=float(body.get("deadline_s", 0.0)))
            self._register(h, aq)
            return h

        handle = await self._call(op)
        await self._deliver(handle, aq, bool(body.get("stream", False)),
                            writer)

    async def _create_session(self, body: Dict,
                              writer: asyncio.StreamWriter) -> None:
        if await self._refuse_if_draining(writer):
            return
        context = body.get("context")
        if not isinstance(context, list) or \
                not all(isinstance(t, int) for t in context):
            await self._respond(writer, 400,
                                {"error": "context must be a list of ints"})
            return

        def op() -> AgentSession:
            return self.server.session(
                context, adapter_id=int(body.get("adapter_id", 0)),
                tenant=str(body.get("tenant", "default")))

        try:
            sess = await self._call(op)
        except RuntimeError as exc:      # context prefill failed
            await self._respond(writer, 503, {"error": str(exc)})
            return
        sid = f"s{next(self._session_ids)}"
        self._sessions[sid] = sess
        await self._respond(writer, 200,
                            {"session_id": sid,
                             "context_tokens": len(sess.context),
                             "adapter_id": sess.adapter_id,
                             "tenant": sess.tenant})

    async def _fork(self, sid: str, body: Dict,
                    writer: asyncio.StreamWriter) -> None:
        if await self._refuse_if_draining(writer):
            return
        sess = self._sessions.get(sid)
        if sess is None or not sess.alive:
            await self._respond(writer, 404,
                                {"error": f"no session {sid!r}"})
            return
        instruction = body.get("instruction", [])
        if not isinstance(instruction, list) or \
                not all(isinstance(t, int) for t in instruction):
            await self._respond(
                writer, 400, {"error": "instruction must be a list of ints"})
            return
        try:
            sp = _sampling_from(body)
        except ValueError as exc:
            await self._respond(writer, 400, {"error": str(exc)})
            return
        aq: asyncio.Queue = asyncio.Queue()

        def op() -> GenerationHandle:
            h = sess.fork(int(body.get("adapter_id", sess.adapter_id)),
                          instruction, sampling=sp,
                          deadline_s=float(body.get("deadline_s", 0.0)))
            self._register(h, aq)
            return h

        handle = await self._call(op)
        await self._deliver(handle, aq, bool(body.get("stream", False)),
                            writer)

    async def _close_session(self, sid: str,
                             writer: asyncio.StreamWriter) -> None:
        sess = self._sessions.pop(sid, None)
        if sess is None:
            await self._respond(writer, 404,
                                {"error": f"no session {sid!r}"})
            return
        await self._call(sess.close)
        await self._respond(writer, 200, {"closed": sid})

    # ------------------------------------------------------------ delivery
    async def _deliver(self, handle: GenerationHandle, aq: asyncio.Queue,
                       stream: bool, writer: asyncio.StreamWriter) -> None:
        """Forward one request's events (``_write_events``), then count
        its response as written, however the writing ended: ``drained``
        waits for it."""
        try:
            await self._write_events(handle, aq, stream, writer)
        finally:
            self._undelivered.discard(handle.rid)

    async def _write_events(self, handle: GenerationHandle,
                            aq: asyncio.Queue, stream: bool,
                            writer: asyncio.StreamWriter) -> None:
        """SSE when streaming, one JSON document otherwise.  The FIRST
        event decides the HTTP status — a request refused before any
        token (shed / too long / deadline) becomes a real error status
        even in stream mode, since no SSE bytes have been written yet."""
        first = await aq.get()
        if first["finished"] and first["index"] == 0:
            out = await self._call(handle.result)
            status = _status_for(out.finish_reason, out.retry_after_s)
            if status != 200 or not stream:
                extra = {}
                if status == 429:
                    # ceil with a floor of 1: round() turned any hint
                    # under 0.5 s into "Retry-After: 0", telling a
                    # compliant client (our own ForkClient backoff
                    # included) to retry IMMEDIATELY and hammer the
                    # already-overloaded server
                    extra["Retry-After"] = \
                        str(max(1, math.ceil(out.retry_after_s)))
                await self._respond(writer, status, self._final_doc(out),
                                    extra_headers=extra)
                return
            # legitimate zero-token completion on a stream request:
            # fall through to SSE so the client still gets its terminal
            # event in the format it asked for.
        if not stream:
            out = await self._call(handle.result)
            await self._respond(writer, 200, self._final_doc(out))
            return
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        ev = first
        while True:
            if ev["finished"]:
                out = await self._call(handle.result)
                doc = self._final_doc(out)
                doc["finished"] = True
                writer.write(b"data: " + json.dumps(doc).encode() +
                             b"\n\n")
                await writer.drain()
                return
            writer.write(b"data: " +
                         json.dumps({"token": ev["token"],
                                     "index": ev["index"],
                                     "ts": ev.get("ts", 0.0)}).encode() +
                         b"\n\n")
            await writer.drain()
            ev = await aq.get()

    @staticmethod
    def _final_doc(out) -> Dict:
        return {"rid": out.rid, "adapter_id": out.adapter_id,
                "tenant": out.tenant, "tokens": out.tokens,
                "finish_reason": out.finish_reason, "error": out.error,
                "retry_after_s": out.retry_after_s, "metrics": out.metrics}

    @staticmethod
    async def _respond(writer: asyncio.StreamWriter, status: int,
                       payload: Dict,
                       extra_headers: Optional[Dict[str, str]] = None
                       ) -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  408: "Request Timeout", 429: "Too Many Requests",
                  500: "Internal Server Error",
                  503: "Service Unavailable",
                  504: "Gateway Timeout"}.get(status, "Error")
        body = json.dumps(payload, default=str).encode()
        head = [f"HTTP/1.1 {status} {reason}",
                "Content-Type: application/json",
                f"Content-Length: {len(body)}",
                "Connection: close"]
        for k, v in (extra_headers or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await writer.drain()


# --------------------------------------------------------------------------
# Client
# --------------------------------------------------------------------------
class ForkClient:
    """Minimal stdlib client for :class:`HttpFrontend` (tests + smoke +
    examples).  One connection per call — the server closes after each
    response.

    ``max_retries > 0`` turns on transient-failure retry for the
    non-streaming endpoints (``completion`` / ``fork`` /
    ``create_session``): a 429 or 503 is retried after a jittered
    exponential backoff, with a ``Retry-After`` header (the server's
    deterministic hint) overriding the computed delay when longer.
    Streams are never retried — tokens may already have been consumed.
    The attempt count is surfaced as ``client_retries`` in the returned
    document (or ``HttpError.retries`` on final failure)."""

    RETRYABLE = (429, 503)

    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 timeout: float = 120.0, max_retries: int = 0,
                 backoff_s: float = 0.25, backoff_cap_s: float = 4.0,
                 retry_seed: int = 0):
        self.host, self.port, self.timeout = host, port, timeout
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self._rng = random.Random(retry_seed)

    def _retry_delay(self, attempt: int, headers: Dict[str, str]) -> float:
        base = min(self.backoff_cap_s, self.backoff_s * (2 ** attempt))
        # full-jitter-lite: [0.5, 1.0) x base decorrelates a thundering
        # herd of clients while keeping the delay seed-deterministic
        delay = base * (0.5 + self._rng.random() / 2)
        ra = headers.get("retry-after")
        if ra:
            try:
                delay = max(delay, float(ra))
            except ValueError:
                pass
        return delay

    def _with_retry(self, call: Callable[[], Dict]) -> Dict:
        """Run ``call`` with up to ``max_retries`` retries on 429/503."""
        attempt = 0
        while True:
            try:
                doc = call()
                if isinstance(doc, dict):
                    doc["client_retries"] = attempt
                return doc
            except HttpError as exc:
                if exc.status not in self.RETRYABLE or \
                        attempt >= self.max_retries:
                    exc.retries = attempt
                    raise
                time.sleep(self._retry_delay(attempt, exc.headers))
                attempt += 1

    # ------------------------------------------------------------- plumbing
    def _request(self, method: str, path: str,
                 payload: Optional[Dict] = None
                 ) -> Tuple[int, Dict[str, str], Dict]:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            body = json.dumps(payload).encode() if payload is not None \
                else None
            conn.request(method, path, body=body,
                         headers={"Content-Type": "application/json"}
                         if body else {})
            resp = conn.getresponse()
            data = resp.read()
            headers = {k.lower(): v for k, v in resp.getheaders()}
            return resp.status, headers, json.loads(data) if data else {}
        finally:
            conn.close()

    def _stream(self, method: str, path: str,
                payload: Dict) -> Iterator[Dict]:
        """Yield SSE ``data:`` events; raises on a non-200 response
        carrying the error document in ``args[1]``."""
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            conn.request(method, path, body=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status != 200:
                doc = json.loads(resp.read() or b"{}")
                raise HttpError(resp.status, doc,
                                {k.lower(): v for k, v in
                                 resp.getheaders()})
            while True:
                line = resp.readline()
                if not line:
                    return
                line = line.strip()
                if not line.startswith(b"data: "):
                    continue
                ev = json.loads(line[len(b"data: "):])
                yield ev
                if ev.get("finished"):
                    return
        finally:
            conn.close()

    # ------------------------------------------------------------ endpoints
    def healthz(self) -> bool:
        status, _, doc = self._request("GET", "/healthz")
        return status == 200 and bool(doc.get("ok"))

    def metrics(self) -> Dict:
        status, _, doc = self._request("GET", "/v1/metrics")
        if status != 200:
            raise HttpError(status, doc, {})
        return doc

    def drain(self) -> Dict:
        status, _, doc = self._request("POST", "/v1/drain")
        if status != 200:
            raise HttpError(status, doc, {})
        return doc

    def completion(self, prompt: List[int], **kw) -> Dict:
        """Non-streaming completion; returns the final document.  Raises
        :class:`HttpError` for refused requests (429/400/500/503/504)
        after exhausting ``max_retries`` on the retryable ones."""
        def call() -> Dict:
            status, headers, doc = self._request(
                "POST", "/v1/completions", {"prompt": prompt, **kw})
            if status != 200:
                raise HttpError(status, doc, headers)
            return doc
        return self._with_retry(call)

    def stream_completion(self, prompt: List[int], **kw) -> Iterator[Dict]:
        return self._stream("POST", "/v1/completions",
                            {"prompt": prompt, "stream": True, **kw})

    def create_session(self, context: List[int], **kw) -> str:
        def call() -> Dict:
            status, headers, doc = self._request(
                "POST", "/v1/sessions", {"context": context, **kw})
            if status != 200:
                raise HttpError(status, doc, headers)
            return doc
        return self._with_retry(call)["session_id"]

    def fork(self, session_id: str, instruction: List[int], **kw) -> Dict:
        def call() -> Dict:
            status, headers, doc = self._request(
                "POST", f"/v1/sessions/{session_id}/fork",
                {"instruction": instruction, **kw})
            if status != 200:
                raise HttpError(status, doc, headers)
            return doc
        return self._with_retry(call)

    def stream_fork(self, session_id: str, instruction: List[int],
                    **kw) -> Iterator[Dict]:
        return self._stream("POST", f"/v1/sessions/{session_id}/fork",
                            {"instruction": instruction, "stream": True,
                             **kw})

    def close_session(self, session_id: str) -> None:
        status, _, doc = self._request("DELETE",
                                       f"/v1/sessions/{session_id}")
        if status != 200:
            raise HttpError(status, doc, {})


class HttpError(RuntimeError):
    """Non-200 response: ``status``, parsed ``doc``, response headers
    (lower-cased keys — ``retry-after`` for 429s)."""

    def __init__(self, status: int, doc: Dict, headers: Dict[str, str]):
        super().__init__(f"HTTP {status}: {doc.get('error', doc)}")
        self.status = status
        self.doc = doc
        self.headers = headers
        self.retries = 0        # attempts the client burned before giving up
