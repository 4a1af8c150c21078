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

Two cardinality soaks run through the same door into a real
``DetectorPipeline`` on the card (``device="cpu"`` for the CPU):
``measure_million_key_soak`` streams a million distinct (tenant ×
service) keys into a 4096-service sketch and checks the bounded intern
table, and ``measure_churn_soak`` streams three key budgets of one-shot
keys through the key lifecycle plane (``runtime.keyspace``) and checks
that the live cohort survives every sweep. There is no Python decode
fallback: both raise when the native decoder or the front door does not
build.
"""

from __future__ import annotations

import socket
import threading
import time

from . import wire
from .ingest_pool import IngestPool, IngestPoolSaturated
from .ingestbench import make_payloads, measure_pooled
from .tensorize import SpanTensorizer

ONE_MILLION = 1_000_000
# The bounded-interner memory gate: RSS growth per million distinct keys
# streamed must stay under this (the reference's ceiling: the old
# append-only table's measured leak; crossing it means the bomb leaks
# again).
SOAK_RSS_CEILING_MB_PER_MILLION = 900.0


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


def make_fleet_payloads(
    n_requests: int,
    services_per_request: int = 4096,
    tenants: int = 16,
    start_index: int = 0,
) -> list[bytes]:
    """OTLP trace payloads whose every span belongs to a distinct
    (tenant × service) key — one resource_spans block per service, one
    span each."""
    payloads = []
    key = start_index
    for _ in range(n_requests):
        names = []
        for _ in range(services_per_request):
            names.append(f"t{key % tenants:02d}.svc-{key:07d}")
            key += 1
        payloads.append(make_named_payload(names))
    return payloads


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


# ---------------------------------------------------------------------------
# million-key soak
# ---------------------------------------------------------------------------

def _rss_kb() -> int | None:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    try:
        import resource

        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
    except Exception:  # noqa: BLE001 — RSS is best-effort off-linux
        return None


def measure_million_key_soak(
    target_keys: int = 1_048_576,
    services_per_request: int = 4096,
    tenants: int = 16,
    workers: int = 2,
    num_services: int = 4096,
    batch: int = 4096,
    via_frontdoor: bool = True,
    clients: int = 2,
    device: "str | None" = None,
) -> dict:
    """Drive ``target_keys`` distinct (tenant × service) keys through
    ingest → sketch → query and report what scale costs.

    Payloads are generated in waves (a resident list of a million-key
    corpus would bill its own footprint to the thing under test); every
    wave goes through the front door's sockets (``pool.submit`` with
    ``via_frontdoor=False``) into a real ``DetectorPipeline`` on
    ``device`` (the card unless ``"cpu"``; at 4096 services the sketch
    kernel opts in to more than 48 KB of shared memory), then the
    query-side checks run against the drained state:

    - the intern table is bounded: exactly ``min(target_keys,
      capacity)`` keys hold dense slots after the storm
      (``intern_exact``);
    - every published (name → id) pair reads back bit-stable through a
      batched re-intern (``readback_ok``);
    - keys past capacity fold into the overflow bucket unmemorized;
      ``overflow_keys`` reports the refused-assign count;
    - ``merge_shard_arrays`` still refuses a drifted geometry at this
      table size (``drift_refused``);
    - ``frames_corrupt`` is 0 across every pooled flush.

    RSS is sampled before generation and after the final drain;
    ``rss_per_million_keys_mb`` is the headline and ``soak_rss_ok``
    gates it under ``SOAK_RSS_CEILING_MB_PER_MILLION``.
    """
    import numpy as np

    from ..models.detector import AnomalyDetector, DetectorConfig
    from .fleet import ShardMergeError, merge_shard_arrays
    from .frontdoor import FrontDoorServer
    from .pipeline import DetectorPipeline

    n_requests = -(-target_keys // services_per_request)
    total_keys = n_requests * services_per_request
    rss_before = _rss_kb()

    config = DetectorConfig(
        num_services=num_services, hll_p=8, cms_width=1024
    )
    det = AnomalyDetector(config, device=device)
    reports = [0]
    pipe = DetectorPipeline(
        det,
        on_report=lambda t, r, flagged: reports.__setitem__(
            0, reports[0] + 1
        ),
        batch_size=batch,
    )
    pool = IngestPool(
        pipe.submit_columns, pipe.tensorizer, workers=workers,
        coalesce_max=64, max_pending=512,
    )
    fd = (
        FrontDoorServer(pool, port=0, max_body_bytes=64 << 20,
                        max_conns=clients + 2)
        if via_frontdoor else None
    )

    pump_stop = threading.Event()

    def pump_loop() -> None:
        while not pump_stop.is_set():
            pipe.pump()
            time.sleep(0.001)

    pump = threading.Thread(target=pump_loop, name="soak-pump", daemon=True)
    pump.start()

    def ship(wave: list[bytes]) -> None:
        if fd is not None:
            counts: dict = {}
            lock = threading.Lock()
            # One pass over the wave per client lane, no repeat loop.
            per = -(-len(wave) // clients)
            lanes = [wave[i * per:(i + 1) * per] for i in range(clients)]

            def lane(payloads: list[bytes]) -> None:
                s = socket.create_connection(("127.0.0.1", fd.port))
                s.settimeout(60.0)
                try:
                    for p in payloads:
                        s.sendall(
                            b"POST /v1/traces HTTP/1.1\r\nHost: soak\r\n"
                            b"Content-Length: %d\r\n\r\n" % len(p) + p
                        )
                        buf = b""
                        while b"\r\n\r\n" not in buf:
                            chunk = s.recv(65536)
                            if not chunk:
                                raise ConnectionError("closed")
                            buf += chunk
                        with lock:
                            if buf.split(b" ", 2)[1] == b"200":
                                counts["ok"] = counts.get("ok", 0) + 1
                finally:
                    s.close()

            threads = [
                threading.Thread(target=lane, args=(ln,), daemon=True)
                for ln in lanes if ln
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300.0)
        else:
            for p in wave:
                while True:
                    try:
                        pool.submit(p)
                        break
                    except IngestPoolSaturated:
                        pipe.pump()
                        time.sleep(0.001)

    t0 = time.perf_counter()
    wave_requests = max(1, (32 << 20) // (services_per_request * 120))
    shipped = 0
    try:
        while shipped < n_requests:
            n = min(wave_requests, n_requests - shipped)
            wave = make_fleet_payloads(
                n, services_per_request, tenants,
                start_index=shipped * services_per_request,
            )
            ship(wave)
            shipped += n
            pipe.pump()
        pool.drain()
        pipe.pump()
        pipe.drain()
    finally:
        if fd is not None:
            fd.stop()
        pump_stop.set()
        pump.join(timeout=10.0)
        pool_stats = pool.stats()
        pool.close()
        pipe.close()
    elapsed = time.perf_counter() - t0
    rss_after = _rss_kb()

    tz = pipe.tensorizer
    capacity = tz.capacity
    expected_live = min(total_keys, capacity)
    distinct = tz.live_keys
    # Refused-assign count before the read-back below re-consults the
    # table.
    overflow_keys = int(tz.overflow_assigns_total)
    # Read-back identity: every (name → id) pair the table published
    # must survive a batched re-intern bit-stable. Which keys won the
    # dense slots is admission order across concurrent client lanes, so
    # the sample comes from the table, not the generated sequence.
    snap = tz._svc_snapshot  # noqa: SLF001 — the lock-free read surface
    live_names = list(snap)
    sample = live_names[:: max(len(live_names) // 1024, 1)] or live_names
    readback_ok = bool(sample) and (
        tz.intern_many(sample) == [snap[n] for n in sample]
    )

    # Fleet drift refusal at scale: a shard whose sketch geometry
    # drifted by one row must still be refused when the shared table is
    # a million keys deep.
    rows = max(num_services, 1 << 14)
    a = {"cms_bank": np.ones((rows, 64), np.int32)}
    b = {"cms_bank": np.ones((rows + 1, 64), np.int32)}
    try:
        merge_shard_arrays(a, b)
        drift_refused = False
    except ShardMergeError:
        drift_refused = True

    keys_m = total_keys / ONE_MILLION
    rss_delta_mb = (
        (rss_after - rss_before) / 1024.0
        if rss_after is not None and rss_before is not None else None
    )
    rss_per_million = (
        rss_delta_mb / keys_m if rss_delta_mb is not None else None
    )
    return {
        "target_keys": target_keys,
        "distinct_keys": total_keys,
        "distinct_interned": distinct,
        "intern_capacity": capacity,
        "intern_exact": bool(distinct == expected_live),
        "readback_ok": bool(readback_ok),
        "overflow_keys": overflow_keys,
        "sketch_num_services": num_services,
        "tenants": tenants,
        "reports": reports[0],
        "frames_corrupt": int(pool_stats.get("frames_corrupt", 0)),
        "decode_errors": int(pool_stats.get("decode_errors", 0)),
        "drift_refused": bool(drift_refused),
        "via_frontdoor": fd is not None,
        "device": str(det.device),
        "elapsed_s": elapsed,
        "keys_per_sec": total_keys / elapsed,
        "rss_before_kb": rss_before,
        "rss_after_kb": rss_after,
        "rss_per_million_keys_mb": rss_per_million,
        # None where RSS is unmeasurable or the run was trimmed below
        # half a million keys: fixed overhead (the allocators, the
        # kernels' libraries) divided by a small key count swamps the
        # per-million normalization.
        "soak_rss_ok": (
            bool(rss_per_million <= SOAK_RSS_CEILING_MB_PER_MILLION)
            if rss_per_million is not None
            and total_keys >= ONE_MILLION // 2 else None
        ),
        "soak_ok": bool(
            distinct == expected_live
            and readback_ok
            and drift_refused
            and pool_stats.get("frames_corrupt", 0) == 0
        ),
    }


# ---------------------------------------------------------------------------
# churn soak: the key-lifecycle plane's survival gate
# ---------------------------------------------------------------------------

def measure_churn_soak(
    num_services: int = 512,
    live_cohort: int = 32,
    churn_multiple: int = 3,
    waves: int = 8,
    tenants: int = 16,
    workers: int = 2,
    via_frontdoor: bool = True,
    idle_s: float = 0.25,
    hold_s: float = 0.02,
    rss_slope_limit_mb: float = 64.0,
    device: "str | None" = None,
) -> dict:
    """Stream ``churn_multiple`` × the key budget of distinct keys
    through a keyspace-enabled pipeline on ``device`` (the card unless
    ``"cpu"``) and prove the lifecycle plane survives the bomb without
    losing the legitimate tenants.

    Every wave ships a fresh batch of one-shot churn keys plus the same
    ``live_cohort`` of legitimate services (re-shipped right before
    each eviction tick, so recency — not a whitelist — keeps them
    alive). The ``KeyspaceManager`` is ticked between waves: pressure
    saturates at the high watermark, the ladder engages after
    ``hold_s``, idle churn keys fold into a real on-disk history tier
    and their ids recycle under a generation bump. The gates:

    - ``live_ids_stable``: the live cohort's intern ids are identical
      after every sweep;
    - ``evicted_query_ok``: an evicted churn key still answers on the
      query plane from history, labeled ``source:"evicted"``;
    - ``gen_refused``: a fleet merge across the generation bump raises
      ``ShardMergeError``;
    - ``frames_corrupt == 0`` across every pooled flush;
    - ``rss_slope_ok``: RSS growth from mid-soak to end stays under
      ``rss_slope_limit_mb``.
    """
    import tempfile

    import numpy as np

    from ..models.detector import AnomalyDetector, DetectorConfig
    from .fleet import ShardMergeError, merge_shard_arrays
    from .frontdoor import FrontDoorServer
    from .history import HistoryReader, HistoryStore, HistoryWriter
    from .keyspace import KeyspaceManager
    from .pipeline import DetectorPipeline
    from .query import QueryEngine

    capacity = num_services - 1
    churn_per_wave = max(1, -(-churn_multiple * capacity // waves))
    live_names = [
        f"t{i % tenants:02d}.live-{i:03d}" for i in range(live_cohort)
    ]
    rungs = (0.5, 60.0)

    config = DetectorConfig(
        num_services=num_services, hll_p=8, cms_width=1024
    )
    det = AnomalyDetector(config, device=device)
    reports = [0]
    pipe = DetectorPipeline(
        det,
        on_report=lambda t, r, flagged: reports.__setitem__(
            0, reports[0] + 1
        ),
        batch_size=num_services,
        keyspace_enable=True,
        keyspace_high_watermark=0.85,
        keyspace_low_watermark=0.70,
        keyspace_hold_s=hold_s,
        # The soak exercises the evict rung; a huge refill rate keeps a
        # transient throttle excursion from parking churn keys.
        keyspace_newkey_rate=1e9,
        keyspace_retry_after_s=0.5,
    )
    tz = pipe.tensorizer

    def snap() -> tuple[dict, dict]:
        # Stream-ordered under the dispatch lock (state_snapshot).
        arrays, _clock = pipe.state_snapshot()
        meta = {
            "service_names": tz.service_names,
            "config": list(config._replace(sketch_impl=None)),
            "generation": tz.generation,
            "query": {},
        }
        return arrays, meta

    pool = IngestPool(
        pipe.submit_columns, pipe.tensorizer, workers=workers,
        coalesce_max=64, max_pending=256,
    )
    fd = (
        FrontDoorServer(pool, port=0, max_body_bytes=8 << 20, max_conns=4)
        if via_frontdoor else None
    )
    conn = (
        socket.create_connection(("127.0.0.1", fd.port))
        if fd is not None else None
    )
    if conn is not None:
        conn.settimeout(30.0)

    shed = [0]

    def post(payload: bytes) -> None:
        if conn is not None:
            conn.sendall(
                b"POST /v1/traces HTTP/1.1\r\nHost: churn\r\n"
                b"Content-Length: %d\r\n\r\n" % len(payload) + payload
            )
            buf = b""
            while b"\r\n\r\n" not in buf:
                chunk = conn.recv(65536)
                if not chunk:
                    raise ConnectionError("front door closed mid-soak")
                buf += chunk
            if buf.split(b" ", 2)[1] != b"200":
                shed[0] += 1
        else:
            while True:
                try:
                    pool.submit(payload)
                    return
                except IngestPoolSaturated:
                    pipe.pump()
                    time.sleep(0.001)

    tmpdir = tempfile.TemporaryDirectory(prefix="churnsoak-")
    store = HistoryStore(tmpdir.name)
    # Writer thread not started: the window ladder is not under test;
    # the evictor calls record_eviction directly.
    writer = HistoryWriter(store, snap, rungs=rungs)
    mgr = KeyspaceManager(
        pipe, idle_s=idle_s, evict_batch=num_services,
        history_writer=writer,
    )

    live_ids: list[int] = []
    live_stable = True
    max_level = 0
    rss_mid = rss_end = None
    t0 = time.perf_counter()
    try:
        for w in range(waves):
            churn = [
                f"t{j % tenants:02d}.churn-{w:03d}-{j:05d}"
                for j in range(churn_per_wave)
            ]
            post(make_named_payload(churn))
            pool.drain()
            pipe.pump()
            max_level = max(max_level, mgr.tick()["level"])
            # Let this wave's churn go idle; the live cohort is
            # re-shipped after the sleep so recency protects it at the
            # eviction tick below.
            time.sleep(idle_s + 0.05)
            post(make_named_payload(live_names))
            pool.drain()
            pipe.pump()
            max_level = max(max_level, mgr.tick()["level"])
            snapshot = tz._svc_snapshot  # noqa: SLF001
            if not live_ids:
                live_ids = [snapshot.get(n) for n in live_names]
            else:
                live_stable = live_stable and all(
                    snapshot.get(n) == sid
                    for n, sid in zip(live_names, live_ids)
                )
            # De-escalation ticks: eviction dropped fill below the low
            # watermark; walk the ladder back down so a long soak never
            # staircases to the shed rung.
            for _ in range(3):
                time.sleep(hold_s + 0.01)
                mgr.tick()
            if w == waves // 2:
                rss_mid = _rss_kb()
        pool.drain()
        pipe.pump()
        pipe.drain()
        rss_end = _rss_kb()
    finally:
        if conn is not None:
            conn.close()
        if fd is not None:
            fd.stop()
        pool_stats = pool.stats()
        pool.close()
    elapsed = time.perf_counter() - t0

    try:
        live_stable = live_stable and bool(live_ids) and all(
            sid is not None for sid in live_ids
        )
        arrays, _meta = snap()
        live_rows_ok = bool(live_ids) and all(
            sid is not None and bool(np.any(arrays["hll_bank"][:, :, sid, :]))
            for sid in live_ids
        )

        # An evicted churn key must still answer from history, labeled.
        evicted_name = next(
            (
                n for w in range(waves) for n in (
                    f"t{j % tenants:02d}.churn-{w:03d}-{j:05d}"
                    for j in range(churn_per_wave)
                )
                if n not in tz._svc_snapshot  # noqa: SLF001
            ),
            None,
        ) if mgr.evictions else None
        evicted_query_ok = False
        if evicted_name is not None:
            engine = QueryEngine(
                snap, history=HistoryReader(store, rungs=rungs)
            )
            try:
                got = engine.cardinality(evicted_name)
                evicted_query_ok = got["meta"].get("source") == "evicted"
            except Exception:  # noqa: BLE001 — a failed read is a failed gate
                evicted_query_ok = False
    finally:
        pipe.close()

    # Fleet pair across the generation bump: refused.
    a = {"cms_bank": np.ones((64, 16), np.int32)}
    b = {"cms_bank": np.ones((64, 16), np.int32)}
    try:
        merge_shard_arrays(
            a, b, dst_generation=tz.generation, src_generation=0
        )
        gen_refused = False
    except ShardMergeError:
        gen_refused = True

    rss_slope_mb = (
        (rss_end - rss_mid) / 1024.0
        if rss_end is not None and rss_mid is not None else None
    )
    rss_slope_ok = (
        bool(rss_slope_mb <= rss_slope_limit_mb)
        if rss_slope_mb is not None else None
    )
    frames_corrupt = int(pool_stats.get("frames_corrupt", 0))
    tmpdir.cleanup()
    return {
        "capacity": capacity,
        "distinct_streamed": live_cohort + churn_per_wave * waves,
        "live_cohort": live_cohort,
        "waves": waves,
        "evictions": int(mgr.evictions),
        "sweeps": int(mgr.sweeps),
        "generation": int(tz.generation),
        "evicted_total": int(tz.evicted_total),
        "overflow_assigns": int(tz.overflow_assigns_total),
        "eviction_records": int(writer.evictions_recorded),
        "max_level": int(max_level),
        "shed_responses": int(shed[0]),
        "reports": int(reports[0]),
        "via_frontdoor": fd is not None,
        "device": str(det.device),
        "elapsed_s": elapsed,
        "live_ids_stable": bool(live_stable),
        "live_rows_ok": bool(live_rows_ok),
        "evicted_query_ok": bool(evicted_query_ok),
        "gen_refused": bool(gen_refused),
        "frames_corrupt": frames_corrupt,
        "rss_mid_kb": rss_mid,
        "rss_end_kb": rss_end,
        "rss_slope_mb": rss_slope_mb,
        "rss_slope_ok": rss_slope_ok,
        "churn_ok": bool(
            mgr.evictions > 0
            and tz.generation > 0
            and live_stable
            and live_rows_ok
            and evicted_query_ok
            and gen_refused
            and frames_corrupt == 0
            and rss_slope_ok is not False
        ),
    }


def main() -> None:
    import json
    import os

    perf = measure_frontdoor_vs_pool(
        workers=int(os.environ.get("BENCH_FRONTDOOR_WORKERS", "2")),
        seconds=float(os.environ.get("BENCH_FRONTDOOR_SECONDS", "4.0")),
    )
    soak = measure_million_key_soak(
        target_keys=int(os.environ.get("BENCH_FRONTDOOR_KEYS", str(1_048_576))),
    )
    churn = measure_churn_soak(waves=int(os.environ.get("BENCH_CHURN_WAVES", "8")))
    # On one core neither door can overlap anything: no verdict.
    eligible = (os.cpu_count() or 1) >= 2
    print(json.dumps({
        "metric": "frontdoor_vs_pool_and_million_key_soak",
        "frontdoor": perf,
        "soak": soak,
        "churn": churn,
        "frontdoor_ok": perf["frontdoor_spans_per_sec"] >= perf["pool_spans_per_sec"] if eligible else None,
        "soak_ok": soak["soak_ok"],
        "soak_rss_ok": soak["soak_rss_ok"],
        "churn_ok": churn["churn_ok"],
    }, sort_keys=True))

if __name__ == "__main__":
    main()
