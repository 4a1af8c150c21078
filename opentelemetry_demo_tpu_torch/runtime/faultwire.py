"""Fault-injecting TCP proxy: the chaos harness's wire layer.

The reference injects every failure through flagd flags — network
misbehaviour included (``kafkaQueueProblems`` starves the consumer from
inside the broker path). This proxy injects the failures a *flag
cannot*: the transport faults between the detector and its
dependencies. Park it between the daemon and the in-repo Kafka broker
(or an OTLP receiver) and it can, per the chaos plan:

- **delay** every forwarded chunk (``delay_s``) — congested link;
- **truncate mid-frame** (``truncate_after`` bytes client→upstream,
  then a hard RST) — a peer dying mid-protocol-frame, the case length-
  prefixed protocols like Kafka's are most sensitive to;
- **RST new connections** (``rst_connects``) — a listener that accepts
  and immediately resets, the half-crashed-broker shape;
- **blackhole** (``blackhole``) — accept and read but forward nothing:
  the half-open connection that pins naive clients forever;
- **corrupt** (``corrupt_rate`` / ``corrupt_seed`` /
  ``corrupt_offset``) — deterministic seeded BIT FLIPS in forwarded
  bytes: each absolute per-direction stream offset ≥ ``corrupt_offset``
  flips one bit with probability ``corrupt_rate``, chosen by a
  splitmix64 hash of (seed, offset) so the same plan replays exactly
  regardless of TCP chunk boundaries. This is the silent-corruption
  shape checksums exist for — a NIC/switch/DMA flipping bits that TCP's
  16-bit checksum misses — and the chaos proof that a flipped byte on
  the replication link is caught at the frame boundary
  (``runtime.frame``), quarantined and survived, never merged.
  :func:`corrupt_bytes` exposes the same deterministic flip plan for
  at-rest corruption (chaos tests flip checkpoint FILES with it);
- **kill live connections** (:meth:`kill_connections`) — RST both
  sides of every in-flight session, the broker-restart shape.

Faults are plain attributes, togglable at runtime (tests flip them
mid-stream), and env-seedable in the spirit of the reference's
flag-driven failures: ``FAULTWIRE_DELAY_MS``,
``FAULTWIRE_TRUNCATE_AFTER``, ``FAULTWIRE_RST=1``,
``FAULTWIRE_BLACKHOLE=1``, ``FAULTWIRE_CORRUPT_RATE`` (flip
probability per byte), ``FAULTWIRE_CORRUPT_SEED``,
``FAULTWIRE_CORRUPT_OFFSET`` (spare the first N bytes of each
direction — e.g. let a handshake through clean).

This is a test/chaos tool with a real socket surface — the daemon under
test cannot tell it from a misbehaving network, which is the point.
"""

from __future__ import annotations

import os
import socket
import struct
import threading


def _splitmix64(x: int) -> int:
    """Scalar splitmix64 (ops.hashing's generator, stdlib-only here):
    the per-offset corruption coin — hash quality matters because the
    flip plan must look like random line noise, not a pattern a
    checksum could be accidentally blind to."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def corrupt_bytes(
    data: bytes,
    seed: int,
    rate: float,
    start: int = 0,
    offset: int = 0,
) -> tuple[bytes, int]:
    """Deterministic seeded bit-flip plan → (mutated bytes, n_flipped).

    Byte at absolute stream position ``start + i`` flips one bit iff
    ``splitmix64(seed, position)`` lands under ``rate`` — and only at
    positions ≥ ``offset``. Deterministic in (seed, position) alone, so
    the same corruption replays identically across chunk boundaries,
    reconnects and runs; the flipped BIT index comes from the same
    hash. Used by the proxy's live corrupt mode and directly by chaos
    tests for at-rest (checkpoint file) corruption.
    """
    if rate <= 0 or not data:
        return data, 0
    threshold = int(rate * (1 << 32))
    out = None
    flipped = 0
    for i in range(len(data)):
        pos = start + i
        if pos < offset:
            continue
        h = _splitmix64((seed << 1) ^ (pos * 0x9E3779B97F4A7C15 + 1))
        if (h & 0xFFFFFFFF) < threshold:
            if out is None:
                out = bytearray(data)
            out[i] ^= 1 << ((h >> 32) & 7)
            flipped += 1
    return (bytes(out) if out is not None else data), flipped


def _rst_close(sock: socket.socket) -> None:
    """Close with SO_LINGER(1, 0): the kernel sends RST, not FIN — the
    abortive teardown a crashed process produces."""
    try:
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
        )
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class FaultWire:
    """TCP fault proxy: listen on ``host:port``, forward to upstream."""

    def __init__(
        self,
        upstream_host: str,
        upstream_port: int,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.upstream = (upstream_host, upstream_port)
        # Fault plan (mutable at runtime; env-seeded like a fault flag).
        self.delay_s = float(os.environ.get("FAULTWIRE_DELAY_MS", "0")) / 1e3
        trunc = os.environ.get("FAULTWIRE_TRUNCATE_AFTER", "")
        self.truncate_after: int | None = int(trunc) if trunc else None
        self.rst_connects = os.environ.get("FAULTWIRE_RST", "") == "1"
        self.blackhole = os.environ.get("FAULTWIRE_BLACKHOLE", "") == "1"
        # Corrupt mode: deterministic seeded bit flips (see module doc
        # and corrupt_bytes). rate = per-byte flip probability; offset
        # spares each direction's first N stream bytes; positions are
        # per-connection per-direction, so the plan is reproducible.
        self.corrupt_rate = float(
            os.environ.get("FAULTWIRE_CORRUPT_RATE", "0")
        )
        self.corrupt_seed = int(os.environ.get("FAULTWIRE_CORRUPT_SEED", "0"))
        self.corrupt_offset = int(
            os.environ.get("FAULTWIRE_CORRUPT_OFFSET", "0")
        )
        # Stats (observability for assertions and operators).
        self.conns_total = 0
        self.conns_killed = 0
        self.bytes_forwarded = 0
        self.bytes_corrupted = 0
        self._lock = threading.Lock()
        self._pairs: list[tuple[socket.socket, socket.socket]] = []
        self._stop = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._acceptor = threading.Thread(
            target=self._accept_loop, name="faultwire-accept", daemon=True
        )

    # -- control --------------------------------------------------------

    def clear(self) -> None:
        """Drop every fault back to clean forwarding."""
        self.delay_s = 0.0
        self.truncate_after = None
        self.rst_connects = False
        self.blackhole = False
        self.corrupt_rate = 0.0

    def kill_connections(self) -> None:
        """RST both legs of every live session (broker-restart shape)."""
        with self._lock:
            pairs, self._pairs = self._pairs, []
            self.conns_killed += len(pairs)
        for client, up in pairs:
            _rst_close(client)
            _rst_close(up)

    def start(self) -> None:
        self._acceptor.start()

    def stop(self) -> None:
        self._stop = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._acceptor.join(timeout=2.0)
        self.kill_connections()

    # -- data path ------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                client, _addr = self._sock.accept()
            except OSError:
                return
            self.conns_total += 1
            if self.rst_connects:
                _rst_close(client)
                continue
            try:
                up = socket.create_connection(self.upstream, timeout=5.0)
            except OSError:
                # Upstream down: the client sees exactly what it would
                # against the dead upstream — a refused/reset connect.
                _rst_close(client)
                continue
            with self._lock:
                self._pairs.append((client, up))
            # Budget shared across both pump directions so "truncate
            # after N bytes" means N bytes of *protocol*, whichever
            # side is mid-frame when it runs out.
            budget = (
                [self.truncate_after]
                if self.truncate_after is not None else None
            )
            for src, dst, c2u in ((client, up, True), (up, client, False)):
                threading.Thread(
                    target=self._pump, args=(src, dst, c2u, client, up, budget),
                    name="faultwire-pump", daemon=True,
                ).start()

    def _pump(self, src, dst, c2u, client, up, budget) -> None:
        import time as _time

        # Per-direction absolute stream position for the corrupt mode's
        # deterministic flip plan (independent of TCP chunking).
        pos = 0
        try:
            while not self._stop:
                try:
                    chunk = src.recv(65536)
                except OSError:
                    break
                if not chunk:
                    break
                if self.blackhole and c2u:
                    continue  # swallow the request; never answer
                if self.delay_s > 0:
                    _time.sleep(self.delay_s)
                if self.corrupt_rate > 0:
                    # Salt the seed by direction so the two pumps of
                    # one session don't flip mirrored positions.
                    chunk, flipped = corrupt_bytes(
                        chunk,
                        seed=self.corrupt_seed * 2 + (1 if c2u else 0),
                        rate=self.corrupt_rate,
                        start=pos,
                        offset=self.corrupt_offset,
                    )
                    self.bytes_corrupted += flipped
                pos += len(chunk)
                if budget is not None:
                    with self._lock:
                        take = max(min(budget[0], len(chunk)), 0)
                        budget[0] -= take
                        spent = budget[0] <= 0
                    chunk = chunk[:take]
                    if chunk:
                        try:
                            dst.sendall(chunk)
                        except OSError:
                            break
                        self.bytes_forwarded += len(chunk)
                    if spent:
                        # Mid-frame cut: RST both legs so neither side
                        # can mistake this for a graceful close.
                        _rst_close(client)
                        _rst_close(up)
                        break
                    continue
                try:
                    dst.sendall(chunk)
                except OSError:
                    break
                self.bytes_forwarded += len(chunk)
        finally:
            # Half-close propagation: EOF on one side ends the session.
            for s in (src, dst):
                try:
                    s.close()
                except OSError:
                    pass
            with self._lock:
                self._pairs = [
                    p for p in self._pairs if p != (client, up)
                ]
