"""Async streaming front end for the serving engine (DESIGN §16; port of
``repro.serve.frontend``).

A stdlib-only asyncio HTTP server that streams tokens to clients over
Server-Sent Events while the engine runs its compiled megasteps on a
dedicated background thread. The split is strict and it is what keeps
the ONE-device→host-transfer-per-megastep invariant trivially intact:

* the **engine thread** owns the :class:`~repro_torch.serve.engine.ServeEngine`
  and the card exclusively — it drains a thread-safe command queue (submit / cancel /
  metrics / shutdown land exactly at step boundaries, the same host
  points the engine already mutates scheduler state at), runs
  ``engine.step()``, then *publishes*: it diffs each watched
  ``Request.out`` against what the stream has already seen and hands the
  delta to the event loop via ``loop.call_soon_threadsafe``. Tokens come
  out of the one host bundle the step already fetched — publishing reads
  pure host state, no extra device traffic. CUDA's current device and
  ``torch.no_grad`` are per thread: the thread selects the engine's device
  before its first step, ``step()`` carries its own ``no_grad``, and
  :meth:`ServeFrontend.start` builds (or loads) the kernel library before
  the thread starts, so no first launch builds it mid-serve;
* the **event loop** owns sockets only: per-request deltas land in an
  ``asyncio.Queue`` the HTTP handler drains into SSE frames. A consumer
  that stops reading lets its queue grow past ``stream_buffer`` — the
  publisher then cancels the request (slow-client backpressure: the
  engine reclaims slot and pages; the stream ends with
  ``reason="cancelled"``) instead of buffering without bound. The loop's
  thread does no device work.

An exception raised by ``engine.step()`` is kept in ``_fatal``: every
in-flight request is cancelled, the server drains, and :meth:`serve`
raises it to its caller.

Endpoints (HTTP/1.1, hand-rolled — no external deps):

* ``POST /v1/generate`` — body ``{"prompt": [ints], "max_new": n,
  "adapter_id": t, "temperature": x?, "timeout": s?, "stream": bool?}``.
  ``stream`` (default true) returns ``text/event-stream``: one
  ``data: {"token": t}`` event per token, a final ``data: {"done": true,
  "reason": ..., "rid": ...}``; ``stream=false`` buffers and returns one
  JSON body. Sheds map to transport errors: full queue → 503,
  rate-limited tenant → 429, unreachable deadline → 503 — all with
  ``Retry-After`` from the exception's ``retry_after``; malformed
  requests (empty prompt, ``max_new <= 0``) → 400; draining → 503.
* ``POST /v1/cancel`` — ``{"rid": n}``; idempotent, ``{"cancelled":
  bool}``. The rid to cancel arrives in the SSE response's
  ``X-Request-Id`` header (and in the done event / JSON body).
* ``GET /metrics`` — Prometheus text exposition of the engine registry.
* ``GET /healthz`` — liveness + draining flag.
* ``POST /admin/shutdown`` — graceful drain: intake closes (submits 503),
  in-flight requests run to their terminal state and their streams flush,
  then the server exits. :meth:`ServeFrontend.serve` returns only after
  the drain completes, so callers flush metrics/trace dumps after it.
"""

from __future__ import annotations

import asyncio
import json
import queue
import threading

import torch

from repro_torch.serve.scheduler import QueueFullError, RateLimitedError

__all__ = ["ServeFrontend"]


class _Stream:
    """One client's view of one request: the publish cursor into
    ``Request.out`` plus the loop-side delta queue."""

    __slots__ = ("rid", "req", "q", "sent", "dropped", "finished")

    def __init__(self, rid, req):
        self.rid = rid
        self.req = req
        # unbounded on purpose: the sentinel ("done", reason) must always
        # be deliverable. Backpressure is enforced by the publisher
        # checking qsize() against stream_buffer BEFORE pushing more.
        self.q: asyncio.Queue = asyncio.Queue()
        self.sent = 0  # tokens already handed to the loop
        self.dropped = False  # slow client: publisher stopped feeding it
        self.finished = False  # sentinel pushed


class ServeFrontend:
    def __init__(
        self,
        engine,
        *,
        host: str = "127.0.0.1",
        port: int = 8000,
        stream_buffer: int = 512,
        poll_seconds: float = 0.02,
        chaos=None,
    ):
        if stream_buffer < 1:
            raise ValueError(f"stream_buffer must be >= 1, got {stream_buffer}")
        self.engine = engine
        self.host = host
        self.port = port
        self.stream_buffer = stream_buffer
        self.poll_seconds = poll_seconds
        # chaos slow-client injection happens HERE, on the consumer side:
        # stream_delay() stalls the SSE writer, the queue backs up, and
        # the publisher's backpressure path fires for real.
        self.chaos = chaos if chaos is not None else getattr(engine, "chaos", None)
        self._cmds: queue.Queue = queue.Queue()
        self._streams: dict[int, _Stream] = {}  # engine-thread owned
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.AbstractServer | None = None
        self._thread: threading.Thread | None = None
        self._stopping = False  # engine-thread flag: drain then exit
        self._stopped = False  # engine thread exited: _call fails fast
        self._drained: asyncio.Event | None = None
        self._fatal: BaseException | None = None

    # ------------------------------------------------------- engine thread

    def _engine_loop(self) -> None:
        """The only code that touches the engine after :meth:`start`."""
        try:
            try:
                if self.engine.device.type == "cuda":
                    # the card the engine's cache lives on (its device may
                    # carry no index)
                    torch.cuda.set_device(self.engine.kv.pos.device)
            except Exception as e:  # surface through serve(), don't hang clients
                self._fail(e)
            while True:
                self._drain_commands(block=not self.engine.scheduler.in_flight())
                try:
                    if self._fatal is None:
                        self.engine.step()
                except Exception as e:  # surface, don't hang clients
                    self._fail(e)
                self._publish()
                if (
                    self._stopping
                    and not self.engine.scheduler.in_flight()
                    and not self._streams
                ):
                    break
        finally:
            # fail-fast ordering: flip the flag FIRST, then drain the
            # command queue with errors. _call re-checks the flag after
            # enqueueing, so a command can never be stranded between the
            # final drain and thread exit — it is either drained here or
            # its submitter sees _stopped and fails it itself.
            self._stopped = True
            self._fail_pending()
            if self._loop is not None:
                self._loop.call_soon_threadsafe(self._drained.set)

    def _fail(self, exc: Exception) -> None:
        """Keep the engine thread's exception for :meth:`serve` to raise,
        close intake and cancel everything in flight."""
        self._fatal = exc
        self._stopping = True
        self.engine.draining = True
        for req in self.engine.scheduler.in_flight():
            self.engine.cancel(req.rid)

    def _fail_pending(self) -> None:
        """Resolve every queued command future with an error instead of
        leaving its awaiter hanging forever (which on Python 3.12+ would
        also deadlock ``aclose``'s ``wait_closed``). Thread-safe: callable
        from the engine thread's exit path and from ``_call``."""
        while True:
            try:
                _, fut = self._cmds.get_nowait()
            except queue.Empty:
                return
            if fut is not None:
                self._loop.call_soon_threadsafe(
                    self._resolve, fut, None, RuntimeError("engine stopped")
                )

    def _drain_commands(self, block: bool) -> None:
        """Run queued submit/cancel/shutdown closures at the step
        boundary; when the engine is idle, block briefly instead of
        spinning on no-op steps."""
        try:
            cmd = self._cmds.get(timeout=self.poll_seconds) if block \
                else self._cmds.get_nowait()
        except queue.Empty:
            return
        while True:
            fn, fut = cmd
            try:
                result = fn()
            except BaseException as e:
                if fut is not None:
                    self._loop.call_soon_threadsafe(self._resolve, fut, None, e)
            else:
                if fut is not None:
                    self._loop.call_soon_threadsafe(self._resolve, fut, result, None)
            try:
                cmd = self._cmds.get_nowait()
            except queue.Empty:
                return

    @staticmethod
    def _resolve(fut, result, exc) -> None:
        if fut.done():  # cancelled, or already failed by _fail_pending
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)

    def _publish(self) -> None:
        """Diff every watched request's ``out`` against its stream cursor
        and push the deltas to the loop. Runs on the engine thread; reads
        pure host state the step already produced."""
        for rid in list(self._streams):
            stream = self._streams[rid]
            req = stream.req
            new = req.out[stream.sent:]
            if not new and not req.done:
                continue
            stream.sent = len(req.out)
            if not stream.dropped and stream.q.qsize() > self.stream_buffer:
                # slow client: the consumer is not draining its queue.
                # Cancel the request (engine-thread call: we ARE the
                # engine thread) so its slot and pages go back to work
                # that is being read; the done sentinel closes the stream.
                stream.dropped = True
                self.engine.cancel(rid)
                req = stream.req  # reason now stamped
            if req.done:
                del self._streams[rid]
            self._loop.call_soon_threadsafe(
                self._push, stream,
                [] if stream.dropped else new,
                req.done, req.reason,
            )

    def _push(self, stream: _Stream, toks, done: bool, reason) -> None:
        for t in toks:
            stream.q.put_nowait(("token", int(t)))
        if done and not stream.finished:
            stream.finished = True
            stream.q.put_nowait(("done", reason))

    # ---------------------------------------------------- loop-side bridge

    async def _call(self, fn):
        """Run ``fn`` on the engine thread at the next step boundary.
        Raises RuntimeError once the engine thread has exited — a late
        command must fail fast, not await a future nobody will resolve."""
        if self._stopped:
            raise RuntimeError("engine stopped")
        fut = self._loop.create_future()
        self._cmds.put((fn, fut))
        if self._stopped:
            # raced the engine thread's exit: it may have drained before
            # our put landed, so drain (and fail) the residue ourselves
            self._fail_pending()
        return await fut

    async def _submit(self, payload: dict) -> _Stream:
        def do_submit():
            rid = self.engine.submit(
                list(payload["prompt"]),
                int(payload.get("max_new", 32)),
                adapter_id=int(payload.get("adapter_id", 0)),
                temperature=payload.get("temperature"),
                timeout=payload.get("timeout"),
            )
            stream = _Stream(rid, self.engine.scheduler.get(rid))
            self._streams[rid] = stream
            return stream

        return await self._call(do_submit)

    async def cancel(self, rid: int) -> bool:
        return await self._call(lambda: self.engine.cancel(rid))

    async def _start_drain(self) -> None:
        def do_drain():
            self.engine.draining = True
            self._stopping = True

        await self._call(do_drain)

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> int:
        """Start the engine thread and the HTTP server; returns the bound
        port (useful with ``port=0``)."""
        if self.engine.device.type == "cuda":
            from repro_torch.kernels import build

            build.library()  # built on this thread, before the engine thread runs
        self._loop = asyncio.get_running_loop()
        self._drained = asyncio.Event()
        self._thread = threading.Thread(
            target=self._engine_loop, name="serve-engine", daemon=True
        )
        self._thread.start()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def serve(self) -> None:
        """Run until a graceful shutdown completes: server up, engine
        thread stepping, returns after the drain flushes every stream."""
        if self._server is None:
            await self.start()
        await self._drained.wait()
        await self.aclose()
        if self._fatal is not None:
            raise self._fatal

    async def shutdown(self) -> None:
        """Initiate graceful drain (idempotent): intake closes, in-flight
        work finishes, :meth:`serve` then returns."""
        await self._start_drain()

    async def aclose(self) -> None:
        """Hard-stop the transport after the engine thread exited, and join
        that thread: it signals the drain from its last lines, and a caller
        that returns (and a process that exits) while it still runs races
        interpreter finalization against a thread that has run torch code,
        which can abort the process."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self._thread is not None and (self._stopped or not self._thread.is_alive()):
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------- HTTP/1.1

    async def _handle(self, reader, writer) -> None:
        try:
            line = await reader.readline()
            if not line:
                return
            try:
                method, path, _ = line.decode("latin1").split(" ", 2)
            except ValueError:
                await self._respond(writer, 400, {"error": "bad request line"})
                return
            headers = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            try:
                n = int(headers.get("content-length", "0") or 0)
            except ValueError:
                await self._respond(writer, 400, {"error": "bad content-length"})
                return
            if n:
                body = await reader.readexactly(n)
            try:
                await self._route(method, path, body, writer)
            except RuntimeError as e:  # engine stopped mid-request
                await self._try_respond(writer, 503, {"error": str(e)})
            except Exception as e:
                # a handler bug must still answer the client, not just
                # drop the connection (best-effort: headers may be gone)
                await self._try_respond(writer, 500, {"error": str(e)})
        except (ConnectionResetError, asyncio.IncompleteReadError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _route(self, method: str, path: str, body: bytes, writer) -> None:
        path = path.split("?", 1)[0]
        if method == "GET" and path == "/metrics":
            text = await self._call(self.engine.metrics.expose)
            await self._respond_raw(
                writer, 200, text.encode(), "text/plain; version=0.0.4"
            )
        elif method == "GET" and path == "/healthz":
            await self._respond(
                writer, 200,
                {"ok": True, "draining": bool(self.engine.draining)},
            )
        elif method == "POST" and path == "/v1/generate":
            await self._generate(body, writer)
        elif method == "POST" and path == "/v1/cancel":
            try:
                rid = int(json.loads(body or b"{}")["rid"])
            except (ValueError, KeyError, TypeError, json.JSONDecodeError):
                await self._respond(writer, 400, {"error": "need integer rid"})
                return
            await self._respond(writer, 200, {"cancelled": await self.cancel(rid)})
        elif method == "POST" and path == "/admin/shutdown":
            await self.shutdown()
            await self._respond(writer, 200, {"draining": True})
        else:
            await self._respond(writer, 404, {"error": f"no route {method} {path}"})

    async def _generate(self, body: bytes, writer) -> None:
        try:
            payload = json.loads(body or b"{}")
            prompt = payload.get("prompt")
            if not isinstance(prompt, list) or not all(
                isinstance(t, int) for t in prompt
            ):
                raise ValueError("prompt must be a list of token ids")
        except (ValueError, json.JSONDecodeError) as e:
            await self._respond(writer, 400, {"error": str(e)})
            return
        try:
            stream = await self._submit(payload)
        except (QueueFullError, RateLimitedError) as e:
            status = 429 if isinstance(e, RateLimitedError) else 503
            await self._respond(
                writer, status, {"error": str(e), "retry_after": e.retry_after},
                extra={"Retry-After": f"{max(e.retry_after, 0.0):.3f}"},
            )
            return
        except (ValueError, TypeError) as e:
            # TypeError covers non-numeric max_new/adapter_id the int()
            # coercions in do_submit choke on — a client error, not a 500
            await self._respond(writer, 400, {"error": str(e)})
            return
        except RuntimeError as e:  # draining
            await self._respond(
                writer, 503, {"error": str(e)}, extra={"Retry-After": "1"}
            )
            return
        if payload.get("stream", True):
            await self._stream_sse(stream, writer)
        else:
            toks = []
            reason = None
            while True:
                kind, val = await stream.q.get()
                if kind == "token":
                    toks.append(val)
                else:
                    reason = val
                    break
            await self._respond(
                writer, 200, {"rid": stream.rid, "tokens": toks, "reason": reason}
            )

    async def _stream_sse(self, stream: _Stream, writer) -> None:
        # the rid rides the response headers so an HTTP-only client can
        # POST /v1/cancel its own stream before the done event arrives
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            + f"X-Request-Id: {stream.rid}\r\n".encode()
            + b"Connection: close\r\n\r\n"
        )
        try:
            await writer.drain()
            while True:
                kind, val = await stream.q.get()
                if kind == "token":
                    if self.chaos is not None:
                        delay = self.chaos.stream_delay()
                        if delay:
                            await asyncio.sleep(delay)
                    writer.write(
                        b"data: " + json.dumps({"token": val}).encode() + b"\n\n"
                    )
                    await writer.drain()
                else:
                    writer.write(
                        b"data: "
                        + json.dumps(
                            {"done": True, "reason": val, "rid": stream.rid}
                        ).encode()
                        + b"\n\n"
                    )
                    await writer.drain()
                    return
        except (ConnectionResetError, BrokenPipeError):
            # client went away mid-stream: reclaim its slot and pages
            try:
                await self.cancel(stream.rid)
            except RuntimeError:
                pass  # engine already stopped: nothing left to reclaim

    # ------------------------------------------------------------ responses

    async def _respond(self, writer, status: int, obj: dict, extra=None) -> None:
        await self._respond_raw(
            writer, status, json.dumps(obj).encode(), "application/json", extra
        )

    async def _try_respond(self, writer, status: int, obj: dict) -> None:
        """Best-effort error response: the failure may have happened after
        headers were already streamed, or on a dead socket."""
        try:
            await self._respond(writer, status, obj)
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass

    async def _respond_raw(
        self, writer, status: int, body: bytes, ctype: str, extra=None
    ) -> None:
        reasons = {
            200: "OK", 400: "Bad Request", 404: "Not Found",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable",
        }
        head = (
            f"HTTP/1.1 {status} {reasons.get(status, 'OK')}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n"
        )
        for k, v in (extra or {}).items():
            head += f"{k}: {v}\r\n"
        writer.write(head.encode() + b"\r\n" + body)
        await writer.drain()
