"""The port's SSE front end (``repro_torch.serve.ServeFrontend``) over
loopback, against the reference's (``repro.serve.ServeFrontend``).

Each server runs its engine on its own thread and is driven by a raw
``asyncio.open_connection`` client (``port=0``: an ephemeral port). The
tokens the port streams for a set of concurrent multi-tenant requests
equal what the reference's front end streams for the same requests and
what the port's engine produces directly. Also: mid-stream cancellation,
the non-streaming body, 400 / 404 / 429 / 503 with ``Retry-After``,
``/metrics`` and ``/healthz``, graceful drain on ``/admin/shutdown``,
slow-client backpressure, a late call after the drain, and an engine
thread's exception surfacing from ``serve()``.
"""

import asyncio
import json

import pytest
import torch
from test_torch_serve_lifecycle import make_engine, world  # noqa: F401

from repro.serve import ServeFrontend as JFrontend
from repro_torch.serve import ChaosMonkey, ServeFrontend

torch.set_num_threads(2)
PROMPTS = [([1, 5, 9], 0), ([1, 6, 9, 4], 1), ([1, 7, 9, 2, 2], 2), ([1, 8], 1)]


async def open_request(port, method, path, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                 f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers, reader, writer


async def request(port, method, path, body=None):
    """A non-streaming request: (status, headers, parsed body)."""
    status, headers, reader, writer = await open_request(port, method, path, body)
    raw = await reader.readexactly(int(headers["content-length"]))
    writer.close()
    if headers.get("content-type", "").startswith("application/json"):
        return status, headers, json.loads(raw)
    return status, headers, raw


async def sse_events(reader, limit=10_000):
    """``data:`` frames up to and including the done event."""
    events = []
    for _ in range(limit):
        line = await asyncio.wait_for(reader.readline(), timeout=60)
        if not line:
            break
        line = line.strip()
        if line.startswith(b"data: "):
            events.append(json.loads(line[len(b"data: "):]))
            if events[-1].get("done"):
                break
    return events


def tokens(events) -> list:
    return [e["token"] for e in events if "token" in e]


def stream_scenario(front_cls, eng) -> dict:
    """Four concurrent SSE streams (three tenants and the base), one more
    cancelled after its first token, one non-streaming body; then drain."""
    out = {}

    async def scenario():
        front = front_cls(eng, port=0)
        port = await front.start()
        opened = [await open_request(port, "POST", "/v1/generate",
                                     {"prompt": p, "max_new": 6, "adapter_id": a})
                  for p, a in PROMPTS]
        assert all(o[0] == 200 for o in opened)
        assert opened[0][1]["content-type"].startswith("text/event-stream")
        evs = await asyncio.gather(*(sse_events(o[2]) for o in opened))
        for o in opened:
            o[3].close()
        out["streams"] = [tokens(e) for e in evs]
        out["reasons"] = [e[-1]["reason"] for e in evs]
        st, hc, rdr, w = await open_request(port, "POST", "/v1/generate",
                                            {"prompt": [1, 3, 9], "max_new": 40})
        rid = int(hc["x-request-id"])
        first = await sse_events(rdr, limit=1)
        st, _, body = await request(port, "POST", "/v1/cancel", {"rid": rid})
        rest = await sse_events(rdr)
        w.close()
        out["cancel"] = (len(tokens(first)), body["cancelled"], rest[-1]["reason"],
                         rest[-1]["rid"] == rid)
        st, _, body = await request(port, "POST", "/v1/generate",
                                    {"prompt": PROMPTS[1][0], "max_new": 6, "adapter_id": 1,
                                     "stream": False})
        out["json"] = (st, body["tokens"], body["reason"])
        st, _, body = await request(port, "POST", "/admin/shutdown")
        out["shutdown"] = (st, body)
        await front.serve()
        out["fatal"] = front._fatal

    asyncio.run(scenario())
    return out


def test_streams_equal_the_reference_front_ends(world):
    direct, _ = make_engine(world, "port", tenants=True, tracer=False, slots=3)
    for p, a in PROMPTS:
        direct.submit(p, max_new=6, adapter_id=a)
    expect = [r.out for r in direct.run_to_completion()]

    seen = {}
    for side, cls in (("ref", JFrontend), ("port", ServeFrontend)):
        eng, _ = make_engine(world, side, tenants=True, tracer=False, slots=3)
        seen[side] = stream_scenario(cls, eng)
        assert eng.draining and eng.kv.drained()
    assert seen["port"] == seen["ref"]
    port = seen["port"]
    assert port["streams"] == expect
    assert port["reasons"] == ["max_new"] * len(PROMPTS)
    assert port["cancel"] == (1, True, "cancelled", True)
    assert port["json"] == (200, expect[1], "max_new")
    assert port["shutdown"] == (200, {"draining": True}) and port["fatal"] is None


def test_status_codes_metrics_and_drain(world):
    eng, _ = make_engine(world, "port", tracer=False, queue_limit=8)

    async def scenario():
        front = ServeFrontend(eng, port=0)
        port = await front.start()
        for body, needle in (({"prompt": [], "max_new": 4}, "empty prompt"),
                             ({"prompt": [1, 2], "max_new": 0}, "max_new"),
                             ({"prompt": "not-a-list"}, "prompt"),
                             ({"prompt": [1, 5, 9], "max_new": 2, "temperature": "hot"},
                              "temperature"),
                             ({"prompt": [1, 5, 9], "max_new": 2, "timeout": "soon"}, "timeout"),
                             ({"prompt": [1, 5, 9], "max_new": "lots"}, "")):
            st, _, out = await request(port, "POST", "/v1/generate", {**body, "stream": False})
            assert st == 400 and needle in out["error"], (body, st, out)
        st, _, _ = await request(port, "POST", "/v1/cancel", {"rid": "x"})
        assert st == 400
        st, _, _ = await request(port, "GET", "/nope")
        assert st == 404
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Length: ZZ\r\n\r\n")
        await writer.drain()
        assert int((await reader.readline()).split()[1]) == 400
        writer.close()
        # a flooded tenant: 429 with Retry-After
        eng.scheduler.set_rate_limit(0, rate=0.001, burst=1.0)
        body = {"prompt": [1, 5, 9], "max_new": 2, "stream": False}
        st1, _, out1 = await request(port, "POST", "/v1/generate", body)
        st2, h2, out2 = await request(port, "POST", "/v1/generate", body)
        assert st1 == 200 and len(out1["tokens"]) == 2
        assert st2 == 429 and float(h2["retry-after"]) > 0 and out2["retry_after"] > 0
        eng.scheduler.clear_rate_limit(0)
        st, _, health = await request(port, "GET", "/healthz")
        assert st == 200 and health == {"ok": True, "draining": False}
        st, h, text = await request(port, "GET", "/metrics")
        assert st == 200 and h["content-type"].startswith("text/plain")
        samples = {}
        for line in text.decode().splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                samples[name] = float(value)
        assert samples['serve_requests_finished_total{tenant="0", reason="max_new"}'] == 1
        assert samples['serve_requests_shed_total{reason="rate_limit"}'] == 1
        assert samples["serve_transfers_total"] == eng.steps
        # drain: an in-flight stream flushes, then intake answers 503
        sd, _, rdr, w = await open_request(port, "POST", "/v1/generate",
                                           {"prompt": [1, 8, 9], "max_new": 6})
        st, _, out = await request(port, "POST", "/admin/shutdown")
        assert sd == 200 and st == 200 and out["draining"]
        ev = await sse_events(rdr)
        w.close()
        assert ev[-1]["reason"] == "max_new" and len(tokens(ev)) == 6
        await front._drained.wait()
        st, _, out = await asyncio.wait_for(request(port, "GET", "/metrics"), timeout=5)
        assert st == 503 and "engine stopped" in out["error"]
        await front.serve()

    asyncio.run(scenario())
    assert eng.draining and eng.kv.drained()
    with pytest.raises(RuntimeError, match="draining"):
        eng.submit([1, 2], max_new=2)


def test_queue_full_is_503_with_retry_after(world):
    eng, _ = make_engine(world, "port", tracer=False, slots=1, queue_limit=1)

    async def scenario():
        front = ServeFrontend(eng, port=0)
        port = await front.start()
        streams = [await open_request(port, "POST", "/v1/generate",
                                      {"prompt": p, "max_new": 30})
                   for p in ([1, 5, 9], [1, 6, 9])]
        assert [s[0] for s in streams] == [200, 200]
        await sse_events(streams[0][2], limit=1)
        st, h, out = await request(port, "POST", "/v1/generate",
                                   {"prompt": [1, 7, 9], "max_new": 4, "stream": False})
        assert st == 503 and float(h["retry-after"]) > 0 and "queue full" in out["error"]
        for _, _, rdr, w in streams:
            await sse_events(rdr)
            w.close()
        await request(port, "POST", "/admin/shutdown")
        await front.serve()

    asyncio.run(scenario())
    assert eng.kv.drained()
    assert eng.metrics.get("serve_requests_shed_total").labels("queue_full").value == 1


def test_slow_client_is_cancelled_by_backpressure(world):
    eng, _ = make_engine(world, "port", tracer=False, slots=1)
    chaos = ChaosMonkey(seed=0, slow_client_prob=1.0, slow_client_delay=0.25)

    async def scenario():
        front = ServeFrontend(eng, port=0, stream_buffer=4, chaos=chaos)
        port = await front.start()
        st, _, rdr, w = await open_request(port, "POST", "/v1/generate",
                                           {"prompt": [1, 5, 9], "max_new": 60})
        ev = await sse_events(rdr)
        w.close()
        assert st == 200 and ev[-1]["reason"] == "cancelled" and len(tokens(ev)) < 60
        await request(port, "POST", "/admin/shutdown")
        await front.serve()

    asyncio.run(scenario())
    assert chaos.injected["slow_client"] > 0 and eng.kv.drained()
    assert eng.metrics.get("serve_requests_cancelled_total").total == 1


def test_engine_thread_failure_surfaces_from_serve(world, monkeypatch):
    """A step that raises is kept, every stream ends cancelled, the server
    drains, and ``serve()`` raises the step's exception to its caller."""
    eng, _ = make_engine(world, "port", tracer=False, slots=2)
    real, calls = eng.step, []

    def failing_step():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected step failure")
        return real()

    monkeypatch.setattr(eng, "step", failing_step)

    async def scenario():
        front = ServeFrontend(eng, port=0)
        port = await front.start()
        st, _, rdr, w = await open_request(port, "POST", "/v1/generate",
                                           {"prompt": [1, 5, 9], "max_new": 30})
        ev = await sse_events(rdr)
        w.close()
        assert st == 200 and ev[-1]["reason"] == "cancelled"
        with pytest.raises(RuntimeError, match="injected step failure"):
            await front.serve()
        assert front._fatal is not None

    asyncio.run(scenario())
    assert eng.draining and eng.kv.drained()
