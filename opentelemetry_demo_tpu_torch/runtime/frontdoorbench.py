"""Front-door throughput: OTLP/HTTP spans/s through the native front
door against the in-process decode pool.

``measure_frontdoor_vs_pool`` sends the same payloads, at the same
worker count, into the same null sink two ways: in process
(``ingestbench.measure_pooled``: ``pool.submit(bytes)``) and over real
sockets through the native front door's framing into the pool. Fat
payloads (4096 spans a request) keep the number about the span path,
not connection scheduling. The door pays sockets and HTTP framing that
the in-process number never does; the ratio says what that costs.

    python -m opentelemetry_demo_tpu_torch.runtime.frontdoorbench

prints one JSON line. The clients (``_post_loop``) are Python: the
claim under test is the server's per-payload loop, not the load
generator's.

The reference's cardinality soaks (a million distinct keys, and key
churn against the evictor) need the fleet, history and query planes,
which the port does not have yet.
"""

from __future__ import annotations

import socket
import threading
import time

from . import wire
from .ingest_pool import IngestPool
from .ingestbench import make_payloads, measure_pooled
from .tensorize import SpanTensorizer


def make_named_payload(names: list[str]) -> bytes:
    """One OTLP trace payload with a single-span resource block per name
    in ``names``: one shared span template, the resource's service.name
    varies (the axis the interner and the sketches key on)."""

    def anyval(s: bytes) -> bytes:
        return wire.encode_len(1, s)

    def kv(k: bytes, v: bytes) -> bytes:
        return wire.encode_len(1, k) + wire.encode_len(2, anyval(v))

    start = 1_700_000_000_000_000_000
    span = (
        wire.encode_len(1, bytes(range(16)))
        + wire.encode_len(5, b"oteldemo.rpc/Call")
        + wire.encode_fixed64(7, start)
        + wire.encode_fixed64(8, start + 5_000_000)
        + wire.encode_len(9, kv(b"app.product.id", b"P-7"))
        + wire.encode_len(9, kv(b"rpc.system", b"grpc"))
    )
    # ResourceSpans.scope_spans (2) wraps ScopeSpans.spans (2).
    scope_spans = wire.encode_len(2, wire.encode_len(2, span))
    rs_bufs = []
    for name in names:
        resource = wire.encode_len(1, kv(b"service.name", name.encode()))
        rs_bufs.append(wire.encode_len(1, wire.encode_len(1, resource) + scope_spans))
    return b"".join(rs_bufs)


def _post_loop(
    port: int,
    payloads: list[bytes],
    stop: threading.Event,
    counts: dict,
    lock: threading.Lock,
    depth: int = 4,
    path: bytes = b"/v1/traces",
) -> None:
    """A keep-alive client: send ``depth`` pipelined POSTs, read
    ``depth`` answers, repeat until ``stop``. Counts answers by status
    (``ok`` for 200, ``status_<code>`` for the rest) and ``sent``. A
    server that closes after its answers (HTTP/1.0, ``Connection:
    close``) gets a new connection for the next burst; against one,
    use ``depth=1``."""
    reqs = [
        b"POST %s HTTP/1.1\r\nHost: bench\r\nContent-Length: %d\r\n\r\n" % (path, len(p)) + p
        for p in payloads
    ]
    s = None
    try:
        i = 0
        buf = b""
        while not stop.is_set():
            if s is None:
                s = socket.create_connection(("127.0.0.1", port))
                s.settimeout(30.0)
                buf = b""
            burst = [reqs[(i + k) % len(reqs)] for k in range(depth)]
            i += depth
            s.sendall(b"".join(burst))
            need = depth
            got: dict[bytes, int] = {}
            closes = False
            while need > 0:
                # Answers are header-only, so one blank line ends each.
                chunk = s.recv(65536)
                if not chunk:
                    raise ConnectionError("server closed mid-burst")
                buf += chunk
                while b"\r\n\r\n" in buf and need > 0:
                    head, buf = buf.split(b"\r\n\r\n", 1)
                    status = head.split(b" ", 2)[1]
                    got[status] = got.get(status, 0) + 1
                    low = head.lower()
                    closes = closes or head.startswith(b"HTTP/1.0") or b"connection: close" in low
                    need -= 1
            if closes:
                s.close()
                s = None
            with lock:
                for status, n in got.items():
                    key = "ok" if status == b"200" else f"status_{status.decode()}"
                    counts[key] = counts.get(key, 0) + n
                counts["sent"] = counts.get("sent", 0) + depth
    except Exception as e:  # noqa: BLE001 — a dying client ends its lane
        if not stop.is_set():
            with lock:
                counts.setdefault("errors", []).append(f"{type(e).__name__}: {e}")
    finally:
        if s is not None:
            s.close()


def _run_frontdoor_clients(
    port: int,
    payloads: list[bytes],
    seconds: float,
    clients: int,
    depth: int,
) -> dict:
    """``clients`` :func:`_post_loop` threads for ``seconds``; their
    counts, the ``elapsed`` wall and the monotonic ``t_start``."""
    stop = threading.Event()
    counts: dict = {"t_start": time.monotonic()}
    lock = threading.Lock()
    threads = [
        threading.Thread(target=_post_loop, args=(port, payloads, stop, counts, lock, depth), daemon=True)
        for _ in range(clients)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=30.0)
    counts["elapsed"] = time.perf_counter() - t0
    counts["clients_alive"] = sum(t.is_alive() for t in threads)
    return counts


def _child_clients(conn, port, phases, clients, depth) -> None:
    try:
        conn.send([_run_frontdoor_clients(port, p, sec, clients, depth) for p, sec in phases])
    finally:
        conn.close()


def run_clients_in_child(
    port: int,
    phases: list[tuple[list[bytes], float]],
    clients: int,
    depth: int,
    timeout_s: float = 120.0,
) -> list[dict]:
    """:func:`_run_frontdoor_clients` for each ``(payloads, seconds)``
    phase in turn, in a spawned interpreter of its own, as a collector
    is another process: the clients then take no share of the server's
    interpreter lock. Returns each phase's counts (``t_start`` is on the
    system-wide monotonic clock)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(
        target=_child_clients, args=(send, port, phases, clients, depth), name="otlp-clients", daemon=True,
    )
    proc.start()
    send.close()
    deadline = time.monotonic() + sum(sec for _p, sec in phases) + timeout_s
    try:
        while not recv.poll(0.1):
            if not proc.is_alive():
                raise RuntimeError(f"the client process exited with {proc.exitcode} before its counts")
            if time.monotonic() > deadline:
                raise TimeoutError("the client process gave no counts in time")
        return recv.recv()
    finally:
        recv.close()
        proc.join(timeout=30.0)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10.0)


def measure_frontdoor_vs_pool(
    workers: int = 2,
    n_requests: int = 12,
    spans_per_request: int = 4096,
    seconds: float = 4.0,
    clients: int = 16,
    depth: int = 2,
    repeat: int = 2,
    payloads: list[bytes] | None = None,
) -> dict:
    """Front-door spans/s against the in-process pool at matched
    geometry: the same payloads, workers, null sink and tensorizer; the
    one difference is the door. Raises when the decoder or the front
    door cannot build."""
    from .frontdoor import FrontDoorServer

    if payloads is None:
        payloads = make_payloads(n_requests, spans_per_request)
    pool_rate = measure_pooled(
        workers=workers, repeat=repeat, passes=16, coalesce=64, payloads=payloads,
        n_requests=n_requests, spans_per_request=spans_per_request,
    )
    pool = IngestPool(
        lambda cols: None, SpanTensorizer(num_services=32), workers=workers, coalesce_max=64,
        max_pending=max(clients * depth * 4, 256),
    )
    try:
        fd = FrontDoorServer(
            pool, port=0, max_body_bytes=64 << 20, batch_max=64, max_conns=clients + 4,
            host="127.0.0.1",
        )
        try:
            # Warmup off the clock: size the scratch, fault the path in.
            warm = _run_frontdoor_clients(fd.port, payloads, min(seconds, 1.0), clients, depth)
            timed = _run_frontdoor_clients(fd.port, payloads, seconds, clients, depth)
        finally:
            fd.stop()
    finally:
        pool.close()
    fd_rate = timed.get("ok", 0) * spans_per_request / timed["elapsed"]
    return {
        "workers": workers,
        "spans_per_request": spans_per_request,
        "clients": clients,
        "pipeline_depth": depth,
        "pool_spans_per_sec": pool_rate,
        "frontdoor_spans_per_sec": fd_rate,
        "frontdoor_vs_pool": fd_rate / pool_rate if pool_rate else None,
        "requests_ok": timed.get("ok", 0),
        "requests_sent": timed.get("sent", 0),
        "client_errors": timed.get("errors", []),
        "warmup_ok": warm.get("ok", 0),
    }


def main() -> None:
    import json
    import os

    perf = measure_frontdoor_vs_pool(
        workers=int(os.environ.get("BENCH_FRONTDOOR_WORKERS", "2")),
        seconds=float(os.environ.get("BENCH_FRONTDOOR_SECONDS", "4.0")),
    )
    # On one core neither door can overlap anything: no verdict.
    eligible = (os.cpu_count() or 1) >= 2
    print(json.dumps({
        "metric": "frontdoor_vs_pool",
        "frontdoor": perf,
        "frontdoor_ok": perf["frontdoor_spans_per_sec"] >= perf["pool_spans_per_sec"] if eligible else None,
    }, sort_keys=True))


if __name__ == "__main__":
    main()
