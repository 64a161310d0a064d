"""Non-blocking HTTP/1.1 front end: selectors event loop + keep-alive —
a copy of ``gene2vec_tpu/serve/eventloop.py`` (framework-neutral), so
the port imports nothing of the reference.

* an **acceptor event loop** (``selectors.DefaultSelector``, so epoll
  on Linux) owns every connection; sockets are non-blocking and all
  socket I/O happens through the loop's ``_fill``/``_flush`` I/O-path
  helpers — no blocking calls (``time.sleep``, ``sendall``/``recv``,
  ``json.dumps``) run inside the ``_on_*`` callbacks themselves;
* **HTTP/1.1 keep-alive** with a bounded requests-per-connection cap
  (``max_conn_requests``) and an **idle timeout**;
* the **slow-loris read deadline**: once a request's first byte
  arrives, the whole request must arrive within ``read_timeout_s`` or
  the loop answers 408 and closes;
* **zero-copy response writes**: a response is a list of reusable
  ``bytes`` buffers handed to ``socket.sendmsg``;
* optional **SO_REUSEPORT multi-acceptor** mode (``acceptors > 1``).

The application side plugs in as a *handler adapter*: a callable
``handler(request, peer) -> Optional[Response]``.  Returning a
:class:`Response` answers inline (the fast path — must not block);
returning ``None`` promises that ``peer.respond(...)`` will be called
later from another thread (a worker pool, the micro-batcher's
completion callback).  ``peer`` is a :class:`ConnHandle` whose
``respond``/``reset``/``close`` are thread-safe: off-loop calls post a
completion and wake the loop through a self-pipe.

``serve_forever()`` / ``shutdown()`` / ``server_close()`` /
``server_address`` follow the ``socketserver`` shell.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import queue as queue_mod
import selectors
import socket
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

__all__ = [
    "BadRequest",
    "ConnHandle",
    "EventLoopConfig",
    "EventLoopHTTPServer",
    "HandlerPool",
    "HTTPRequest",
    "Response",
    "build_head",
]


class HandlerPool:
    """Bounded worker pool for an adapter's full-dispatch path.
    ``submit`` never blocks: a full queue returns False and the front
    end answers 429 — saturation sheds load exactly like the batcher
    queue does."""

    def __init__(self, workers: int, max_queue: int,
                 name: str = "http-worker"):
        self._q: "queue_mod.Queue[Optional[Callable[[], None]]]" = (
            queue_mod.Queue(maxsize=max_queue)
        )
        self._threads = [
            threading.Thread(
                target=self._run, name=f"{name}-{i}", daemon=True
            )
            for i in range(max(1, workers))
        ]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:
                pass  # adapters answer their own 500s; never die

    def submit(self, fn: Callable[[], None]) -> bool:
        try:
            self._q.put_nowait(fn)
            return True
        except queue_mod.Full:
            return False

    def stop(self) -> None:
        for _ in self._threads:
            try:
                self._q.put_nowait(None)
            except queue_mod.Full:
                break
        for t in self._threads:
            t.join(timeout=2.0)



def _apply_reset(sock: socket.socket) -> None:
    """Close ``sock`` with an RST instead of a FIN (SO_LINGER with a zero
    timeout), which the peer sees as ``ConnectionResetError``."""
    import struct

    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass

@dataclasses.dataclass(frozen=True)
class EventLoopConfig:
    """Front-end policy knobs (cli/serve.py + cli/fleet.py flags)."""

    #: slow-loris guard: a request whose first byte has arrived must
    #: arrive COMPLETELY within this window or the loop answers 408 and
    #: closes (the serve/server.py read-deadline contract)
    read_timeout_s: float = 10.0
    #: keep-alive connections idle longer than this are closed silently
    idle_timeout_s: float = 30.0
    #: requests served per connection before the loop answers the last
    #: one with ``Connection: close`` (0 = unbounded)
    max_conn_requests: int = 0
    #: number of acceptor loops; > 1 binds SO_REUSEPORT listening
    #: sockets so the kernel load-balances connections across loops
    acceptors: int = 1
    max_header_bytes: int = 32768
    max_body_bytes: int = 8 << 20
    #: hard cap on one dispatched request with no response (a lost
    #: completion must not leak the connection forever)
    inflight_timeout_s: float = 120.0
    backlog: int = 1024


class HTTPRequest:
    """One parsed request: method, raw target, lowercased header map,
    body bytes.  Header names are latin-1 decoded and lowercased;
    everything else stays bytes until the application needs it."""

    __slots__ = ("method", "target", "headers", "body", "version")

    def __init__(self, method: str, target: str, version: str,
                 headers: Dict[str, str], body: bytes):
        self.method = method
        self.target = target
        self.version = version
        self.headers = headers
        self.body = body


class Response:
    """One response: a status, a reusable body buffer, and a close
    flag.  The body is NOT copied — cached hot responses hand the same
    bytes object to every connection."""

    __slots__ = ("status", "body", "content_type", "close")

    def __init__(self, status: int, body: bytes,
                 content_type: bytes = b"application/json",
                 close: bool = False):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.close = close


class BadRequest(Exception):
    """Protocol violation — the loop answers ``status`` (default 400)
    and closes.  ``body`` is a pre-encoded error document (the loop
    never runs json.dumps)."""

    def __init__(self, message: str, status: int = 400,
                 body: Optional[bytes] = None):
        super().__init__(message)
        self.status = status
        self.body = body


_STATUS_TEXT = {
    200: b"HTTP/1.1 200 OK\r\n",
    400: b"HTTP/1.1 400 Bad Request\r\n",
    404: b"HTTP/1.1 404 Not Found\r\n",
    408: b"HTTP/1.1 408 Request Timeout\r\n",
    413: b"HTTP/1.1 413 Payload Too Large\r\n",
    429: b"HTTP/1.1 429 Too Many Requests\r\n",
    500: b"HTTP/1.1 500 Internal Server Error\r\n",
    502: b"HTTP/1.1 502 Bad Gateway\r\n",
    503: b"HTTP/1.1 503 Service Unavailable\r\n",
    504: b"HTTP/1.1 504 Gateway Timeout\r\n",
}

_CT_PREFIX = b"Content-Type: "
_CL_PREFIX = b"\r\nContent-Length: "
_KEEPALIVE_TAIL = b"\r\n\r\n"
_CLOSE_TAIL = b"\r\nConnection: close\r\n\r\n"

#: Content-Length values are tiny and repeat constantly under load —
#: pre-encode the common ones so the header build is pure concat
_CLEN_CACHE = tuple(str(n).encode("ascii") for n in range(4096))


def build_head(status: int, body_len: int,
               content_type: bytes = b"application/json",
               close: bool = False) -> bytes:
    """One response head from reusable fragments (no f-strings, no
    per-request dict walks — this runs on the loop thread)."""
    line = _STATUS_TEXT.get(status)
    if line is None:
        line = (b"HTTP/1.1 %d Status\r\n" % status)
    clen = (
        _CLEN_CACHE[body_len] if body_len < len(_CLEN_CACHE)
        else str(body_len).encode("ascii")
    )
    return b"".join((
        line, _CT_PREFIX, content_type, _CL_PREFIX, clen,
        _CLOSE_TAIL if close else _KEEPALIVE_TAIL,
    ))


#: pre-encoded loop-generated error bodies: the loop never runs
#: json.dumps (the event-loop-blocking contract)
_BODY_400 = b'{"error": "malformed HTTP request"}'
_BODY_408 = b'{"error": "request read timed out"}'
_BODY_413 = b'{"error": "request too large"}'
_BODY_504 = b'{"error": "handler timed out (inflight cap)"}'

#: bytes of pipelined input buffered per connection while a request is
#: in flight; beyond it the loop stops reading (kernel TCP window
#: backpressures the sender) until the response completes — a client
#: streaming garbage behind a slow request cannot grow our memory
_PIPELINE_BUF_CAP = 256 * 1024


def parse_json_body(req: "HTTPRequest"):
    """Decode a request's JSON object body: ``(body_dict, None)`` or
    ``(None, Response(400, ...))``.  Shared by the serve and fleet
    adapters so the error shape cannot drift between the two V1
    surfaces.  Runs on worker-pool threads, never on the loop."""
    try:
        body = json.loads(req.body.decode("utf-8")) if req.body else {}
        if not isinstance(body, dict):
            raise ValueError("body must be a JSON object")
        return body, None
    except (ValueError, UnicodeDecodeError) as e:
        return None, Response(
            400,
            json.dumps({"error": f"bad JSON body: {e}"}).encode("utf-8"),
        )


class _Conn:
    """Per-connection state: read buffer + incremental parse state,
    write buffer, keep-alive bookkeeping, deadlines."""

    __slots__ = (
        "sock", "fd", "rbuf", "out", "header_end", "method", "target",
        "version", "headers", "content_length", "requests", "seq",
        "inflight", "closing", "deadline", "idle", "want_write",
        "advancing", "paused", "registered_mask",
    )

    def __init__(self, sock: socket.socket, idle_deadline: float):
        self.sock = sock
        self.fd = sock.fileno()
        self.rbuf = bytearray()
        #: outgoing buffers (memoryviews), oldest first
        self.out: Deque[memoryview] = collections.deque()
        self.header_end = -1
        self.method = ""
        self.target = ""
        self.version = ""
        self.headers: Dict[str, str] = {}
        self.content_length = 0
        self.requests = 0
        #: response-generation counter; stale completions are dropped
        self.seq = 0
        self.inflight = False
        self.closing = False
        self.deadline = idle_deadline
        self.idle = True
        self.want_write = False
        self.advancing = False
        self.paused = False
        self.registered_mask = 0


class ConnHandle:
    """The application's thread-safe handle to one in-flight request.
    ``respond`` may be called from any thread exactly once; late calls
    (the connection died, a newer request took over) are dropped."""

    __slots__ = ("_loop", "_conn", "_seq", "close_after")

    def __init__(self, loop: "_AcceptorLoop", conn: _Conn, seq: int,
                 close_after: bool):
        self._loop = loop
        self._conn = conn
        self._seq = seq
        #: the loop decided this request is the connection's last
        #: (request cap / Connection: close); adapters may OR into it
        self.close_after = close_after

    def respond(self, response: Response) -> None:
        self._loop.post(
            self._conn, self._seq, "respond",
            (response, self.close_after),
        )

    def reset(self) -> None:
        """TCP RST + close (fault injection's ``reset`` kind)."""
        self._loop.post(self._conn, self._seq, "reset", None)

    def close(self) -> None:
        """Close without answering (fault injection's blackhole end)."""
        self._loop.post(self._conn, self._seq, "close", None)


class _AcceptorLoop:
    """One selector loop: a listening socket, its connections, a
    self-pipe waker, and a completion queue fed by worker threads."""

    def __init__(self, server: "EventLoopHTTPServer",
                 lsock: socket.socket):
        self.server = server
        self.config = server.config
        self.handler = server.handler
        self.lsock = lsock
        self.sel = selectors.DefaultSelector()
        self.conns: Dict[int, _Conn] = {}
        # cross-thread completion handoff: workers append, the loop
        # drains after a self-pipe wake; deque.append/popleft are
        # GIL-atomic and stale entries are dropped by the seq check
        self._completions: Deque[Tuple[_Conn, int, str, object]] = (
            collections.deque()
        )
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._stop = threading.Event()
        self._thread_id: Optional[int] = None
        self._last_sweep = 0.0

    # -- cross-thread completion path -------------------------------------

    def post(self, conn: _Conn, seq: int, action: str,
             payload: object) -> None:
        """Queue a completion for the loop thread (direct-dispatch when
        already ON the loop thread — the inline fast path)."""
        if threading.get_ident() == self._thread_id:
            self._apply(conn, seq, action, payload)
            return
        self._completions.append((conn, seq, action, payload))
        try:
            self._wake_w.send(b"x")
        except (BlockingIOError, OSError):
            pass  # pipe full = a wakeup is already pending

    def _drain_completions(self) -> None:
        while self._completions:
            conn, seq, action, payload = self._completions.popleft()
            self._apply(conn, seq, action, payload)

    def _apply(self, conn: _Conn, seq: int, action: str,
               payload: object) -> None:
        if conn.fd not in self.conns or seq != conn.seq:
            return  # connection gone or a newer request took over
        if action == "respond":
            resp, close_after = payload  # type: ignore[misc]
            self._queue_response(conn, resp, close_after)
        elif action == "reset":
            try:
                _apply_reset(conn.sock)
            except OSError:
                pass
            self._close(conn)
        elif action == "close":
            self._close(conn)

    # -- selector callbacks -------------------------------------------------
    # The _on_* callbacks below must not block: no sleeps, no blocking socket calls, no JSON
    # encoding — raw I/O lives in the _fill/_flush I/O-path helpers.

    def _on_accept(self) -> None:
        for _ in range(128):  # bounded accept burst per wakeup
            try:
                # non-blocking listener: accept() raises BlockingIOError
                # instead of waiting
                sock, _addr = self.lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return  # listening socket closed under us (shutdown)
            sock.setblocking(False)
            try:
                sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
            except OSError:
                pass  # AF_UNIX or exotic stacks: latency opt only
            conn = _Conn(
                sock, time.monotonic() + self.config.idle_timeout_s
            )
            self.conns[conn.fd] = conn
            self.sel.register(sock, selectors.EVENT_READ, conn)
            conn.registered_mask = selectors.EVENT_READ

    def _on_wake(self) -> None:
        self._drain_waker()

    def _on_readable(self, conn: _Conn) -> None:
        if conn.inflight and len(conn.rbuf) >= _PIPELINE_BUF_CAP:
            # backpressure: while a request is in flight, buffered
            # pipelined bytes are bounded — stop reading (the kernel's
            # TCP window throttles the sender) until the response lands
            self._set_paused(conn, True)
            return
        if not self._fill(conn):
            return
        self._advance(conn)

    def _on_writable(self, conn: _Conn) -> None:
        self._flush(conn)

    def _update_interest(self, conn: _Conn) -> None:
        """Reconcile the selector registration with the connection's
        desired interest: READ unless paused (backpressure), WRITE
        while the out-buffer has bytes.  A fully quiesced connection
        (paused, nothing to write) is unregistered until un-paused —
        the kernel's TCP window then throttles the sender."""
        if conn.fd not in self.conns:
            return
        mask = (0 if conn.paused else selectors.EVENT_READ) | (
            selectors.EVENT_WRITE if conn.want_write else 0
        )
        if mask == conn.registered_mask:
            return
        try:
            if mask == 0:
                self.sel.unregister(conn.sock)
            elif conn.registered_mask == 0:
                self.sel.register(conn.sock, mask, conn)
            else:
                self.sel.modify(conn.sock, mask, conn)
            conn.registered_mask = mask
        except (KeyError, ValueError, OSError):
            pass

    def _set_paused(self, conn: _Conn, paused: bool) -> None:
        if conn.paused != paused:
            conn.paused = paused
            self._update_interest(conn)

    # -- raw I/O (the writer/reader path; blocking-call pass exempt) -------

    def _drain_waker(self) -> None:
        """Drain the (non-blocking) self-pipe."""
        try:
            # non-blocking self-pipe read; loop exits on BlockingIOError
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass

    def _fill(self, conn: _Conn) -> bool:
        """Read what the socket has.  False when the connection died
        (and was cleaned up)."""
        try:
            # conn sockets are non-blocking (setblocking(False) at accept)
            chunk = conn.sock.recv(262144)
        except (BlockingIOError, InterruptedError):
            return True
        except OSError:
            self._close(conn)
            return False
        if not chunk:
            self._close(conn)  # peer closed; nothing sensible to finish
            return False
        if conn.idle and not conn.inflight:
            # first byte of a new request: arm the slow-loris deadline
            conn.idle = False
            conn.deadline = time.monotonic() + self.config.read_timeout_s
        conn.rbuf += chunk
        return True

    def _flush(self, conn: _Conn) -> None:
        """Drain the write buffer; closes on completion when the
        connection is marked closing."""
        sock = conn.sock
        out = conn.out
        try:
            while out:
                if len(out) > 1:
                    n = sock.sendmsg(tuple(out)[:16])
                else:
                    n = sock.send(out[0])
                while n > 0 and out:
                    head = out[0]
                    if n >= len(head):
                        n -= len(head)
                        out.popleft()
                    else:
                        out[0] = head[n:]
                        n = 0
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._close(conn)
            return
        if out:
            if not conn.want_write:
                conn.want_write = True
                self._update_interest(conn)
        else:
            if conn.want_write:
                conn.want_write = False
                self._update_interest(conn)
            if conn.closing:
                self._close(conn)

    # -- request parsing / dispatch ----------------------------------------

    def _parse(self, conn: _Conn) -> Optional[HTTPRequest]:
        """One incremental parse step; None when more bytes are needed.
        Raises :class:`BadRequest` on protocol violations."""
        buf = conn.rbuf
        if conn.header_end < 0:
            idx = buf.find(b"\r\n\r\n")
            if idx < 0:
                if len(buf) > self.config.max_header_bytes:
                    raise BadRequest("headers exceed the size cap")
                return None
            head = bytes(buf[:idx])
            del buf[: idx + 4]
            lines = head.split(b"\r\n")
            parts = lines[0].split(b" ")
            if len(parts) != 3 or not parts[2].startswith(b"HTTP/1."):
                raise BadRequest("malformed request line")
            try:
                conn.method = parts[0].decode("ascii")
                conn.target = parts[1].decode("latin-1")
                conn.version = parts[2].decode("ascii")
            except UnicodeDecodeError:
                raise BadRequest("malformed request line") from None
            headers: Dict[str, str] = {}
            for ln in lines[1:]:
                name, sep, value = ln.partition(b":")
                if not sep:
                    raise BadRequest("malformed header line")
                headers[name.strip().lower().decode("latin-1")] = (
                    value.strip().decode("latin-1")
                )
            cl_raw = headers.get("content-length", "0")
            try:
                conn.content_length = int(cl_raw)
            except ValueError:
                raise BadRequest("malformed Content-Length") from None
            if conn.content_length < 0:
                raise BadRequest("negative Content-Length")
            if conn.content_length > self.config.max_body_bytes:
                raise BadRequest(
                    "body exceeds the size cap", status=413,
                    body=_BODY_413,
                )
            conn.headers = headers
            conn.header_end = 0
        if len(buf) < conn.content_length:
            return None
        body = bytes(buf[: conn.content_length])
        del buf[: conn.content_length]
        req = HTTPRequest(
            conn.method, conn.target, conn.version, conn.headers, body
        )
        conn.header_end = -1
        conn.content_length = 0
        conn.headers = {}
        return req

    def _advance(self, conn: _Conn) -> None:
        """Parse and dispatch as many buffered requests as possible.
        One request is in flight per connection at a time; buffered
        pipelined requests are picked up as each response completes.
        The ``advancing`` guard keeps inline responses (handler answers
        synchronously -> _queue_response -> _advance) iterative: the
        outer while drains pipelined requests without re-entering."""
        if conn.advancing:
            return
        conn.advancing = True
        try:
            self._advance_inner(conn)
        finally:
            conn.advancing = False

    def _advance_inner(self, conn: _Conn) -> None:
        while not conn.inflight and not conn.closing:
            try:
                req = self._parse(conn)
            except BadRequest as e:
                self._error_out(
                    conn, e.status,
                    e.body if e.body is not None else _BODY_400,
                )
                return
            if req is None:
                if conn.rbuf or conn.header_end >= 0:
                    pass  # mid-request: the read deadline stays armed
                else:
                    conn.idle = True
                    conn.deadline = (
                        time.monotonic() + self.config.idle_timeout_s
                    )
                return
            conn.requests += 1
            cap = self.config.max_conn_requests
            close_after = bool(cap and conn.requests >= cap)
            if req.headers.get("connection", "").lower() == "close":
                close_after = True
            elif req.version == "HTTP/1.0" and req.headers.get(
                "connection", ""
            ).lower() != "keep-alive":
                close_after = True
            conn.seq += 1
            conn.inflight = True
            conn.idle = False
            conn.deadline = (
                time.monotonic() + self.config.inflight_timeout_s
            )
            peer = ConnHandle(self, conn, conn.seq, close_after)
            try:
                resp = self.handler(req, peer)
            except Exception:
                resp = Response(500, b'{"error": "handler crashed"}')
            if resp is not None:
                self._queue_response(conn, resp, peer.close_after)

    def _queue_response(self, conn: _Conn, resp: Response,
                        close_after: Optional[bool] = None) -> None:
        close = resp.close or bool(close_after)
        head = build_head(
            resp.status, len(resp.body), resp.content_type, close
        )
        conn.out.append(memoryview(head))
        if resp.body:
            conn.out.append(memoryview(resp.body))
        conn.inflight = False
        if close:
            conn.closing = True
        else:
            conn.idle = not conn.rbuf
            conn.deadline = time.monotonic() + (
                self.config.idle_timeout_s if conn.idle
                else self.config.read_timeout_s
            )
            self._set_paused(conn, False)  # resume a backpressured reader
        self._flush(conn)
        if conn.fd in self.conns and not conn.closing:
            self._advance(conn)  # pipelined requests already buffered

    def _error_out(self, conn: _Conn, status: int, body: bytes) -> None:
        conn.closing = True
        conn.inflight = False
        conn.seq += 1  # orphan any in-flight completion
        conn.out.append(
            memoryview(build_head(status, len(body), close=True))
        )
        conn.out.append(memoryview(body))
        if self.server.on_protocol_error is not None:
            try:
                self.server.on_protocol_error(status)
            except Exception:
                pass  # accounting must never take the loop down
        self._flush(conn)

    # -- deadlines ----------------------------------------------------------

    def _sweep(self, now: float) -> None:
        if now - self._last_sweep < 0.05:
            return
        self._last_sweep = now
        expired = [
            c for c in self.conns.values() if now >= c.deadline
        ]
        for conn in expired:
            if conn.inflight:
                # a dispatched request whose completion never came back
                conn.seq += 1
                self._error_out(conn, 504, _BODY_504)
            elif conn.rbuf or conn.header_end >= 0:
                # slow loris: a started request that never finished
                self._error_out(conn, 408, _BODY_408)
            else:
                self._close(conn)  # idle keep-alive expiry

    # -- lifecycle ----------------------------------------------------------

    def _close(self, conn: _Conn) -> None:
        if self.conns.pop(conn.fd, None) is None:
            return
        if conn.registered_mask != 0:
            try:
                self.sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            conn.registered_mask = 0
        try:
            conn.sock.close()
        except OSError:
            pass
        conn.seq += 1  # drop any straggler completions

    def run(self) -> None:
        self._thread_id = threading.get_ident()
        self.sel.register(self.lsock, selectors.EVENT_READ, "accept")
        self.sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        try:
            while not self._stop.is_set():
                events = self.sel.select(timeout=0.05)
                for key, mask in events:
                    data = key.data
                    if data == "accept":
                        self._on_accept()
                    elif data == "wake":
                        self._on_wake()
                    else:
                        conn = data
                        if conn.fd not in self.conns:
                            continue  # closed earlier this wakeup
                        if mask & selectors.EVENT_WRITE:
                            self._on_writable(conn)
                        if (
                            mask & selectors.EVENT_READ
                            and conn.fd in self.conns
                        ):
                            self._on_readable(conn)
                self._drain_completions()
                self._sweep(time.monotonic())
        finally:
            for conn in list(self.conns.values()):
                self._close(conn)
            try:
                self.sel.unregister(self.lsock)
            except (KeyError, ValueError, OSError):
                pass
            self.sel.close()
            self._wake_r.close()
            self._wake_w.close()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass


def _bind(host: str, port: int, reuseport: bool,
          backlog: int) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if reuseport:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind((host, port))
    s.listen(backlog)
    s.setblocking(False)
    return s


class EventLoopHTTPServer:
    """N acceptor loops over one (host, port).  ``handler`` is the
    adapter callable; ``on_protocol_error`` (optional) is invoked with
    the status of loop-generated 400/408/413/504 responses so adapters
    can keep their error counters."""

    def __init__(
        self,
        handler: Callable[[HTTPRequest, ConnHandle], Optional[Response]],
        host: str = "127.0.0.1",
        port: int = 0,
        config: EventLoopConfig = EventLoopConfig(),
        on_protocol_error: Optional[Callable[[int], None]] = None,
    ):
        self.handler = handler
        self.config = config
        self.on_protocol_error = on_protocol_error
        n = max(1, int(config.acceptors))
        reuseport = n > 1 and hasattr(socket, "SO_REUSEPORT")
        first = _bind(host, port, reuseport, config.backlog)
        self.server_address = first.getsockname()
        socks = [first]
        for _ in range(n - 1):
            if not reuseport:
                break
            socks.append(_bind(
                host, self.server_address[1], True, config.backlog
            ))
        self._loops = [_AcceptorLoop(self, s) for s in socks]
        self._threads: List[threading.Thread] = []
        self._threads_lock = threading.Lock()
        self._started = threading.Event()
        self._stopped = threading.Event()

    # -- ThreadingHTTPServer-compatible surface ----------------------------

    def serve_forever(self) -> None:
        """Run every loop (extra loops on daemon threads, the first on
        the calling thread) until :meth:`shutdown`."""
        self._stopped.clear()
        self._started.set()
        # spawn under the lock: a shutdown() racing this loop would
        # otherwise join a partial list and leak later-started threads
        with self._threads_lock:
            for loop in self._loops[1:]:
                t = threading.Thread(
                    target=loop.run, name="http-eventloop", daemon=True
                )
                t.start()
                self._threads.append(t)
        try:
            self._loops[0].run()
        finally:
            self._stopped.set()

    def shutdown(self) -> None:
        for loop in self._loops:
            loop.stop()
        with self._threads_lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=5.0)

    def server_close(self) -> None:
        self.shutdown()
        for loop in self._loops:
            try:
                loop.lsock.close()
            except OSError:
                pass
        closer = getattr(self.handler, "close", None)
        if closer is not None:
            closer()
