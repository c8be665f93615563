"""The port's HTTP front end (DESIGN.md §15) and serve launcher, against
the JAX package.

The tests of ``tests/test_frontend.py`` (token parity with the in-process
API, SSE streaming, session/fork routes, overload shedding with 429 +
Retry-After, queueing deadlines with 504, bad requests, fair share) and
of ``tests/test_faults.py`` for HTTP drain and the client's retry, run on
the port's ``HttpFrontend`` over its CPU ``ForkServer`` with weights
bridged from the reference's.  Greedy tokens over HTTP must equal the
port's in-process API and the reference's in-process ``ForkServer`` on the
same weights, token for token.

Then ``repro_torch.launch.serve``: ``build_server`` on the reference
launcher's own weights serves the reference's greedy tokens, refuses to
pick the CPU on its own, and ``main`` prints the reference's ``--json``
report keys.
"""
import asyncio
import concurrent.futures
import json
import math
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import tiny_serving_model as jtiny
from repro.core.config import ServeConfig as JServeConfig
from repro.launch import serve as jserve
from repro.models import transformer as jtfm
from repro.serving.api import ForkServer as JForkServer
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch import bridge
from repro_torch.configs.paper_models import tiny_serving_model as ttiny
from repro_torch.core.config import ServeConfig as TServeConfig
from repro_torch.launch import serve as tserve
from repro_torch.serving.api import (ForkServer, GenerationHandle,
                                     SamplingParams)
from repro_torch.serving.frontend import ForkClient, HttpError, HttpFrontend

torch.set_num_threads(2)

MODEL = dict(rank=8, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             vocab_size=512)
to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731


@pytest.fixture(scope="module")
def model():
    jcfg = jtiny(**MODEL)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1), n_adapters=16)
    return dict(jax=(jcfg, jparams, jlora),
                torch=(ttiny(**MODEL),
                       bridge.params_from_jax(to_np(jparams), "cpu"),
                       bridge.lora_from_jax(to_np(jlora), "cpu")))


SERVE = dict(page_size=16, max_pages=256, max_batch=4, max_prefill_tokens=64,
             mode="forkkv", max_pages_per_req=12)


def make_server(model, **kw):
    cfg, params, lora = model["torch"]
    return ForkServer(cfg, params, lora, TServeConfig(**{**SERVE, **kw}),
                      device="cpu"), cfg


def make_jax_server(model, **kw):
    cfg, params, lora = model["jax"]
    return JForkServer(cfg, params, lora, JServeConfig(**{**SERVE, **kw}))


@pytest.fixture(scope="module")
def frontend(model):
    server, cfg = make_server(model)
    fe = HttpFrontend(server).start_background()
    yield fe, ForkClient(port=fe.port), cfg
    fe.shutdown()


def prompt_tokens(cfg, n, seed=0):
    return [int(t) for t in
            np.random.default_rng(seed).integers(0, cfg.vocab_size, n)]


def test_healthz_and_metrics(frontend):
    _, client, _ = frontend
    assert client.healthz()
    m = client.metrics()
    for key in ("admission", "queue_depth", "admission_wait_p50_ms",
                "admission_wait_p99_ms", "timeouts", "shed", "tenants",
                "fallback_gather_calls", "http_sessions"):
        assert key in m, key


def test_http_parity_with_in_process(frontend, model):
    """Acceptance: greedy tokens over HTTP == the port's in-process API ==
    the reference's in-process ForkServer on the same weights, with zero
    gather fallbacks."""
    _, client, cfg = frontend
    prompt = prompt_tokens(cfg, 40, seed=7)
    doc = client.completion(prompt, max_new_tokens=8, adapter_id=2)
    assert doc["finish_reason"] == "length" and len(doc["tokens"]) == 8

    ref_server, _ = make_server(model)
    expected = ref_server.generate(
        2, prompt, SamplingParams(max_new_tokens=8)).result().tokens
    assert doc["tokens"] == expected
    jax_tokens = make_jax_server(model).generate(
        2, prompt, JSamplingParams(max_new_tokens=8)).result().tokens
    assert doc["tokens"] == [int(t) for t in jax_tokens]
    assert client.metrics()["fallback_gather_calls"] == 0


def test_sse_stream_matches_terminal_event(frontend):
    # the per-token SSE events must agree with the terminal event's token
    # list exactly (fresh prompt: an identical one continues from the
    # cached suffix by design)
    _, client, cfg = frontend
    prompt = prompt_tokens(cfg, 32, seed=11)
    events = list(client.stream_completion(prompt, max_new_tokens=6))
    streamed = [e["token"] for e in events if not e.get("finished")]
    final = events[-1]
    assert final["finished"] and final["finish_reason"] == "length"
    assert streamed == final["tokens"] and len(streamed) == 6
    assert [e["index"] for e in events[:-1]] == list(range(6))


def test_session_fork_routes(frontend, model):
    """Forked agents over HTTP share the pinned context (CoW) and match
    the in-process session API token for token."""
    _, client, cfg = frontend
    ctx = prompt_tokens(cfg, 48, seed=3)
    sid = client.create_session(ctx, adapter_id=1)
    via_http = client.fork(sid, [5, 6, 7], max_new_tokens=5)["tokens"]
    sibling = client.fork(sid, [5, 6, 8], max_new_tokens=5)["tokens"]

    ref_server, _ = make_server(model)
    sess = ref_server.session(ctx, adapter_id=1)
    expected = sess.fork(1, [5, 6, 7],
                         SamplingParams(max_new_tokens=5)).result().tokens
    assert via_http == expected
    assert len(sibling) == 5
    client.close_session(sid)
    with pytest.raises(HttpError) as ei:
        client.fork(sid, [1, 2])
    assert ei.value.status == 404


def test_shedding_returns_429_with_retry_after(model):
    """Overload: queue bound 1, batch 1 — a burst must shed with 429 and
    a Retry-After hint while admitted requests still finish."""
    server, cfg = make_server(model, max_batch=1, max_queue_depth=1)
    fe = HttpFrontend(server).start_background()
    client = ForkClient(port=fe.port)
    prompt = prompt_tokens(cfg, 40, seed=1)

    def one(i):
        try:
            return ("ok", client.completion(prompt[:32 + i],
                                            max_new_tokens=4))
        except HttpError as exc:
            return ("err", exc)

    try:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            results = list(pool.map(one, range(8)))
        oks = [r for kind, r in results if kind == "ok"]
        errs = [r for kind, r in results if kind == "err"]
        assert oks, "at least one request must be admitted and finish"
        assert all(len(d["tokens"]) == 4 for d in oks)
        shed = [e for e in errs if e.status == 429]
        assert shed, f"burst of 8 over bound 1 must shed ({results})"
        for e in shed:
            # integer seconds: the ceil of the engine's hint, at least 1
            hdr = e.headers["retry-after"]
            assert hdr == str(int(hdr)), "must be integer seconds"
            assert int(hdr) == max(1, math.ceil(e.doc["retry_after_s"]))
            assert e.doc["finish_reason"] == "rejected"
        assert client.metrics()["shed"] == len(shed)
    finally:
        fe.shutdown()


def test_deadline_returns_504(model):
    """A queued request whose deadline lapses before admission finishes
    with 504, while the running request is unaffected."""
    server, cfg = make_server(model, max_batch=1)
    fe = HttpFrontend(server).start_background()
    client = ForkClient(port=fe.port)
    prompt = prompt_tokens(cfg, 40, seed=2)
    try:
        blocker = threading.Thread(
            target=lambda: client.completion(prompt, max_new_tokens=8))
        blocker.start()
        statuses = []
        # keep poking until one lands while the blocker occupies the
        # batch slot (the first may sneak in before the blocker)
        for _ in range(4):
            try:
                client.completion(prompt[:36], max_new_tokens=4,
                                  deadline_s=1e-3)
                statuses.append(200)
            except HttpError as exc:
                statuses.append(exc.status)
            if 504 in statuses:
                break
        blocker.join(timeout=60)
        assert not blocker.is_alive()
        assert 504 in statuses, statuses
        assert client.metrics()["timeouts"] >= 1
    finally:
        fe.shutdown()


def test_bad_requests_are_4xx(frontend):
    _, client, _ = frontend
    with pytest.raises(HttpError) as ei:
        client.completion(["not", "ints"])
    assert ei.value.status == 400
    with pytest.raises(HttpError) as ei:
        client.fork("missing", [1, 2, 3])
    assert ei.value.status == 404


def test_malformed_json_body_is_400(frontend):
    """A syntactically broken JSON body comes back 400 with an error
    document, not a 500 or a dropped connection."""
    import http.client
    fe, _, _ = frontend
    for raw in (b"{not json", b'{"prompt": [1,2,', b"\xff\xfe\x00"):
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=30)
        try:
            conn.request("POST", "/v1/completions", body=raw,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            doc = json.loads(resp.read())
            assert resp.status == 400, raw
            assert "error" in doc
        finally:
            conn.close()


def test_unknown_sampling_keys_are_400(frontend):
    """A typoed sampling key is refused with 400 naming the key, instead
    of being silently dropped into greedy defaults."""
    _, client, cfg = frontend
    prompt = prompt_tokens(cfg, 24, seed=13)
    with pytest.raises(HttpError) as ei:
        client.completion(prompt, max_new_tokens=4, temprature=0.7)
    assert ei.value.status == 400
    assert "temprature" in ei.value.doc["error"]
    with pytest.raises(HttpError) as ei:
        client.completion(prompt, max_new_tokens=4, top_K=5, banana=1)
    assert ei.value.status == 400
    doc = client.completion(prompt, max_new_tokens=3, temperature=0.0,
                            top_k=0, top_p=1.0, seed=0)
    assert len(doc["tokens"]) == 3


def test_fairshare_light_tenant_not_starved(model):
    """With fair share, a light tenant's request admitted behind a hog
    burst does not wait for the hog's whole backlog."""
    server, cfg = make_server(model, admission="fairshare", max_batch=2,
                              tenant_max_concurrent=1)
    fe = HttpFrontend(server).start_background()
    client = ForkClient(port=fe.port)
    prompt = prompt_tokens(cfg, 32, seed=5)

    def hog(i):
        try:
            return client.completion(prompt[:24 + i], max_new_tokens=4,
                                     tenant="hog")
        except HttpError:
            return None

    try:
        with concurrent.futures.ThreadPoolExecutor(7) as pool:
            hogs = [pool.submit(hog, i) for i in range(6)]
            light = pool.submit(
                lambda: client.completion(prompt, max_new_tokens=4,
                                          tenant="light"))
            light_doc = light.result(timeout=120)
            assert len(light_doc["tokens"]) == 4
            [f.result(timeout=120) for f in hogs]
        tenants = client.metrics()["tenants"]
        assert tenants["light"]["accepted"] == 1
        assert tenants["hog"]["accepted"] >= 1
    finally:
        fe.shutdown()


# ------------------------------------------------ drain and client retry
def test_http_drain_503_and_inflight_completion(model):
    """POST /v1/drain while a stream is mid-flight: the stream finishes
    normally, new requests get 503 + Retry-After, /healthz flips to
    draining (503), and the frontend reports drained."""
    server, cfg = make_server(model)
    fe = HttpFrontend(server).start_background()
    client = ForkClient(port=fe.port)
    prompt = prompt_tokens(cfg, 40, seed=71)
    try:
        stream = client.stream_completion(prompt, max_new_tokens=8)
        first = next(stream)            # in flight: >=1 token delivered
        assert not first.get("finished")
        assert client.drain()["draining"]
        with pytest.raises(HttpError) as ei:
            client.completion(prompt[:32], max_new_tokens=4)
        assert ei.value.status == 503
        assert ei.value.doc["finish_reason"] == "draining"
        assert float(ei.value.headers["retry-after"]) >= 1.0
        events = [first] + list(stream)
        assert events[-1]["finished"]
        assert events[-1]["finish_reason"] == "length"
        assert len(events[-1]["tokens"]) == 8
        status, _, doc = client._request("GET", "/healthz")
        assert status == 503 and doc["state"] == "draining"
        deadline = time.time() + 10
        while not fe.drained and time.time() < deadline:
            time.sleep(0.02)
        assert fe.drained
    finally:
        fe.shutdown()


def test_drained_only_after_the_terminal_event_is_written(model,
                                                         monkeypatch):
    """A drained front end has written every response.  The launcher shuts
    it down as soon as it reports drained, and the shut-down pump runs no
    more work: a stream whose terminal event was queued to the event loop
    but not yet written would never get it.  The event loop is made late
    (0.5 s) to ask the pump for the finished request's result, the front
    end is shut down the moment it reports drained, and the open stream
    must still end with its terminal event."""
    server, cfg = make_server(model)
    call = HttpFrontend._call

    async def late_result(self, fn):
        if getattr(fn, "__name__", "") == "result":
            await asyncio.sleep(0.5)
        return await call(self, fn)

    monkeypatch.setattr(HttpFrontend, "_call", late_result)
    fe = HttpFrontend(server).start_background()
    client = ForkClient(port=fe.port, timeout=15)
    events = []
    reader = threading.Thread(target=lambda: events.extend(
        client.stream_completion(prompt_tokens(cfg, 40, seed=72),
                                 max_new_tokens=8)), daemon=True)
    try:
        reader.start()
        deadline = time.time() + 30
        while not events and time.time() < deadline:
            time.sleep(0.005)
        fe.begin_drain()
        while not fe.drained and time.time() < deadline:
            time.sleep(0.005)
        assert fe.drained
    finally:
        fe.shutdown()                   # as the launcher does once drained
    reader.join(timeout=20)
    assert events[-1].get("finished"), events[-1]
    assert len(events[-1]["tokens"]) == 8


def test_client_retry_backoff_on_503(model):
    """503s from a draining server are retried with jittered exponential
    backoff honoring Retry-After, then surfaced with the attempt count; a
    healthy server reports ``client_retries == 0``."""
    server, cfg = make_server(model)
    fe = HttpFrontend(server).start_background()
    prompt = prompt_tokens(cfg, 32, seed=81)
    try:
        ok_client = ForkClient(port=fe.port, max_retries=2)
        doc = ok_client.completion(prompt, max_new_tokens=4)
        assert doc["client_retries"] == 0 and len(doc["tokens"]) == 4

        fe.begin_drain()
        t0 = time.time()
        client = ForkClient(port=fe.port, max_retries=1, backoff_s=0.05)
        with pytest.raises(HttpError) as ei:
            client.completion(prompt[:24], max_new_tokens=4)
        assert ei.value.status == 503
        assert ei.value.retries == 1
        # Retry-After: 1 dominates the 0.05s backoff base
        assert time.time() - t0 >= 1.0
    finally:
        fe.shutdown()


def test_client_retry_delay_honors_retry_after():
    c = ForkClient(max_retries=3, backoff_s=0.25, backoff_cap_s=4.0,
                   retry_seed=7)
    d0 = c._retry_delay(0, {})
    assert 0.125 <= d0 < 0.25
    assert c._retry_delay(0, {"retry-after": "2.5"}) >= 2.5
    assert c._retry_delay(10, {}) <= 4.0      # capped


def test_warm_up_serves_one_request_before_start(model):
    """``warm_up`` runs one request to its end on the calling thread and
    refuses once the front end is running."""
    server, _ = make_server(model)
    fe = HttpFrontend(server)
    fe.warm_up()
    assert server.metrics()["tasks_done"] == 1
    fe.start_background()
    try:
        with pytest.raises(RuntimeError):
            fe.warm_up()
        assert ForkClient(port=fe.port).healthz()
    finally:
        fe.shutdown()


# --------------------------------------------------------- the launcher
def test_build_server_serves_the_reference_launchers_tokens():
    """``build_server`` given the reference launcher's own weights
    (``tiny_serving_model(rank=8)`` at its defaults, head_dim 32; 32
    adapters), bridged, serves the reference server's greedy tokens; with
    no device it serves on the CUDA device and never picks the CPU on its
    own."""
    jsrv, jcfg = jserve.build_server("forkkv", max_pages=128)
    params = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    lora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1), n_adapters=32)
    srv, cfg = tserve.build_server(
        "forkkv", max_pages=128, device="cpu",
        params=bridge.params_from_jax(to_np(params), "cpu"),
        lora=bridge.lora_from_jax(to_np(lora), "cpu"))
    assert cfg.resolved_head_dim == 32 and cfg.lora.rank == 8
    prompt = prompt_tokens(cfg, 40, seed=5)
    got = srv.generate(3, prompt, SamplingParams(max_new_tokens=6)).result()
    want = jsrv.generate(3, prompt,
                         JSamplingParams(max_new_tokens=6)).result()
    assert got.tokens == [int(t) for t in want.tokens]
    assert srv.engine.executor.device.type == "cpu"
    if torch.cuda.is_available():
        cuda_srv, _ = tserve.build_server("forkkv", max_pages=32)
        assert cuda_srv.engine.executor.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.build_server("forkkv", max_pages=32)


WF_ARGS = ["--json", "--workflows", "1", "--agents", "2", "--context", "48",
           "--max-new", "3", "--max-pages", "128"]


def test_main_json_report_keys_match_reference(capsys, monkeypatch):
    """``main(["--device", "cpu", "--json", ...])`` prints the workflow
    report with the reference launcher's keys for the same run."""
    tserve.main(["--device", "cpu", *WF_ARGS])
    got = json.loads(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["serve", *WF_ARGS])
    jserve.main()
    want = json.loads(capsys.readouterr().out)
    assert sorted(got) == sorted(want)
    for key in ("mode", "workflow", "tasks", "tasks_done"):
        assert got[key] == want[key], key


def test_main_prints_the_stats_lines(capsys):
    """The text report with ``--stats``: every line the reference prints,
    in the reference's format."""
    tserve.main(["--device", "cpu", "--workflows", "1", "--agents", "2",
                 "--context", "48", "--max-new", "3", "--max-pages", "128",
                 "--host-tier-mb", "4", "--speculate", "--stats"])
    lines = capsys.readouterr().out.splitlines()
    prefixes = ("mode=", "hit_rate=", "tier_hits=", "kernels=", "batching=",
                "speculate=on", "admission=", "preempted=")
    assert [p for p in prefixes if not any(ln.startswith(p) for ln in lines)
            ] == [], lines
