"""Hot-standby replication: epoch-fenced failover with mergeable-sketch
anti-entropy.

The crash-safe (checkpoint) and overload-safe (backpressure) detector
is still one process: a host loss costs the cold-restart window plus
Kafka replay — exactly the blind window a production observability
sidecar must not have. The paper's kernel choice makes a warm standby
cheap: HLL registers and CMS counters are **commutative monoids**
(``ops.hll.hll_merge`` = elementwise max, ``ops.cms.cms_merge`` =
elementwise add), so replica state ships asynchronously and reconciles
by merge — no ordering, no dedup protocol, the same property the
collectives in ``parallel/`` exploit across cards, here exploited
across *processes*.

Topology: the PRIMARY listens (``ANOMALY_REPLICATION_PORT``); each
STANDBY dials it (``ANOMALY_REPLICATION_TARGET``) and receives a
full-snapshot bootstrap followed by periodic deltas. Messages are
length-prefixed (4-byte big-endian) protobuf-style envelopes built from
``runtime.wire``'s encoding helpers — the same wire discipline as the
Kafka and OTLP seams — and every SNAPSHOT/DELTA payload is ONE verified
columnar frame (``runtime.frame``: magic, version, schema hash,
per-column CRC32C, trailer checksum — the same bytes checkpoints write
to disk and the ingest pool moves to the device feed). The standby
VERIFIES before it merges: a payload failing its checksums is counted
(``anomaly_frame_corrupt_total{hop="replication"}``), quarantined, and
never applied — the ACK of the unchanged ``applied_seq`` doubles as the
NACK that makes the primary reship against the retained base, so a
flipped bit on the link costs one retransmit instead of silently
poisoning sketch state. A corrupt frame still counts as LIVENESS
(``last_frame_t``), so a lossy-but-alive link never starves the
promotion watchdog into split-brain. Un-upgraded peers that still ship
the pre-frame npz payload ("v0") are accepted through
``frame.decode_arrays``'s sniffing shim — a rolling upgrade never
bricks replication mid-failover.

Delta algebra — why a lossy link still converges bit-exactly:

- ``hll_bank`` ships FULL every delta and merges by elementwise max
  (``hll_merge``: idempotent + commutative — any subset of deltas in
  any order, then any later one, equals the primary's registers).
  One caveat the monoid does not cover: window ROTATION resets HLL
  banks, and max can never lower a register. The primary therefore
  checks monotonicity against the peer's acked base and tags the rare
  rotation-spanning frame ``hll_monotone: false`` — the standby
  replaces instead of merging for exactly that frame (the two are
  identical whenever no rotation intervened, because the frame always
  carries the full registers).
- ``cms_bank`` ships as an AGGREGATE delta against the last **acked**
  base: ``delta = current − state_at_last_ack``. If N deltas vanish
  into a blackhole, the primary's base never advances, so the first
  delta through after the partition carries the sum of everything
  missed — one ``cms_merge`` (add) and the standby's counters equal
  the primary's exactly (rotation clears ride through as negative
  delta entries). No replay, no journal.
- Everything else (EWMA means/vars, CUSUM accumulators, window
  counters, ``step_idx``) is replace-latest, tagged by sequence
  number: during flow it lags by at most one replication interval;
  at quiescence (a final delta after load stops) it is bit-identical.
  That bound is the documented EWMA tolerance the anti-entropy test
  asserts.

Epoch fencing (split-brain prevention): every frame, checkpoint and
Kafka offset commit carries a monotonically increasing **epoch**. A
standby promotes by bumping it. A resurrected stale primary is fenced
three ways: replication frames at an old epoch are answered FENCED
(never applied), checkpoint saves refuse when the on-disk snapshot
carries a newer epoch (``checkpoint.StaleEpochError``), and offset
commits are epoch-tagged + fence-guarded (``kafka_orders``). The
:class:`EpochFence` is the process-local authority: it remembers the
largest epoch seen on any channel and refuses writes the moment it
exceeds its own.

Protocol (all frames carry the sender's epoch):

==========  ===========================================================
HELLO       standby → primary: standby id, applied seq, config
            fingerprint. Primary resumes with deltas when it still
            holds that standby's acked base; otherwise snapshots.
SNAPSHOT    primary → standby: full state arrays + meta; replaces
            everything, becomes the acked base.
DELTA       primary → standby: hll full / cms aggregate-delta /
            latest block, tagged (base_seq, seq). Applied only when
            base_seq == the standby's applied seq.
ACK         standby → primary: applied seq. Advances the primary's
            base only when it matches the last ship.
FENCED      standby → primary: your epoch is old; carries the newer
            one. The primary's fence observes it and every subsequent
            guarded write raises :class:`checkpoint.StaleEpochError`.
==========  ===========================================================

The arrays on the link are host numpy with the detector state's
dtypes (int32 banks, float32 heads, a 0-d int32 ``step_idx``), so a
primary and a standby of either package interoperate: a primary built
on the card takes its ``snapshot_fn`` from
``DetectorPipeline.state_snapshot`` (a stream-ordered copy enqueued
under the dispatch lock), and a promoted mirror goes back onto the
card with ``models.detector.state_from_numpy``.
``runtime.replbench.measure_failover`` is the failover drill; the
daemon's roles and live drills come with the daemon.
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time
import uuid
from collections import deque
from typing import Callable

import numpy as np

from . import wire
from . import frame as frame_fmt
from .checkpoint import StaleEpochError

log = logging.getLogger(__name__)

# Roles (the daemon's replication state machine; anomaly_role metric).
ROLE_PRIMARY = "primary"
ROLE_STANDBY = "standby"
ROLE_PROMOTING = "promoting"
# A fenced ex-primary: it discovered a newer epoch, stopped all writes,
# and awaits operator action — visibly, not as a silent zombie.
ROLE_FENCED = "fenced"

# Frame types.
HELLO = 1
SNAPSHOT = 2
DELTA = 3
ACK = 4
FENCED = 5

# Frame fields (protobuf-style numbers over runtime.wire helpers).
_F_TYPE = 1
_F_EPOCH = 2
_F_SEQ = 3
_F_BASE_SEQ = 4
_F_ARRAYS = 5  # ONE columnar frame (runtime.frame); legacy peers: npz
_F_META = 6  # JSON bytes
# Trailing envelope checksum: CRC32C over every preceding body byte,
# appended as a fixed64 (low 32 bits used). The columnar payload
# already self-verifies, but the ENVELOPE — type, epoch, seq, meta —
# did not, and a flipped bit in an ACK's epoch varint could fence a
# healthy primary (the one corruption that causes a ROLE regression
# rather than a bad merge). Presence is sniffed positionally (the
# field is always last), so envelopes from un-upgraded peers that
# never append it still decode — and a frame whose envelope CRC fails
# is SKIPPED (counted, liveness still credited), not a session kill:
# the length-prefixed stream is still aligned, only this frame lied.
_F_BODY_CRC = 7
_CRC_TAG_BYTE = wire.encode_tag(_F_BODY_CRC, 1)[0]  # fixed64 tag
_CRC_FIELD_LEN = 9  # 1 tag byte + 8 value bytes

# State-key merge classes (DetectorState fields). HLL merges by max
# (idempotent), CMS by add (aggregate delta vs acked base); the rest is
# replace-latest — see the module docstring's delta algebra.
MAX_KEYS = ("hll_bank",)
ADD_KEYS = ("cms_bank",)

_MAX_FRAME_BYTES = 256 << 20  # corrupt length prefix guard


class ReplicationError(RuntimeError):
    """Transport/protocol failure on the replication link."""


class EnvelopeCorrupt(Exception):
    """A received envelope failed its trailing CRC: the frame is a lie
    but the length-prefixed stream is still aligned — receivers SKIP
    the frame (count + keep the session) instead of reconnecting.
    Deliberately neither a ReplicationError nor a ValueError so the
    session-fatal catch paths never swallow it."""


class EpochFence:
    """Process-local fencing authority.

    ``epoch`` is this process's own epoch; ``observed`` is the largest
    epoch seen on any channel. Once ``observed > epoch`` the process is
    stale and :meth:`check` raises until an explicit :meth:`bump`
    (promotion) or a restart."""

    def __init__(self, epoch: int = 0):
        self._lock = threading.Lock()
        self.epoch = int(epoch)
        self.observed = int(epoch)
        self.fenced_writes = 0
        # Per-path rejection counts (checkpoint / offsets / history /
        # remediation): the audit trail of a stale process's refused
        # writes.
        self.fenced_by_path: dict[str, int] = {}

    def observe(self, epoch: int) -> None:
        """Record fencing evidence from any channel."""
        with self._lock:
            if epoch > self.observed:
                self.observed = int(epoch)

    def stale(self) -> bool:
        with self._lock:
            return self.observed > self.epoch

    def check(self, path: str = "write") -> None:
        """Raise :class:`checkpoint.StaleEpochError` when stale."""
        with self._lock:
            if self.observed > self.epoch:
                self.fenced_writes += 1
                self.fenced_by_path[path] = self.fenced_by_path.get(path, 0) + 1
                raise StaleEpochError(
                    f"{path} fenced: epoch {self.epoch} superseded by "
                    f"{self.observed}"
                )

    def bump(self) -> int:
        """Promotion: claim an epoch above everything ever observed."""
        with self._lock:
            self.epoch = max(self.epoch, self.observed) + 1
            self.observed = self.epoch
            return self.epoch


# -- framing -----------------------------------------------------------


def encode_frame(
    ftype: int,
    epoch: int,
    seq: int = 0,
    base_seq: int = 0,
    arrays: dict[str, np.ndarray] | None = None,
    meta: dict | None = None,
) -> bytes:
    body = wire.encode_int(_F_TYPE, ftype) + wire.encode_int(_F_EPOCH, epoch)
    if seq:
        body += wire.encode_int(_F_SEQ, seq)
    if base_seq:
        body += wire.encode_int(_F_BASE_SEQ, base_seq)
    if arrays:
        # The ONE columnar frame format (runtime.frame): self-describing
        # dtypes/shapes, per-column CRC32C + trailer checksum — the
        # standby VERIFIES before it merges (a flipped bit on this link
        # used to merge straight into sketch state). Uncompressed:
        # deltas are mostly small ints and the TCP link is local/rack-
        # scale, CPU beats wire here.
        body += wire.encode_len(_F_ARRAYS, frame_fmt.encode(arrays))
    if meta is not None:
        body += wire.encode_len(_F_META, json.dumps(meta).encode())
    body += wire.encode_fixed64(_F_BODY_CRC, frame_fmt.crc32c(body))
    return struct.pack(">I", len(body)) + body


def decode_frame(body: bytes) -> dict:
    """Protocol fields only — the ARRAYS payload stays RAW bytes.

    Deferring the columnar decode to the apply step is deliberate: a
    frame that ARRIVES but fails verification must still count as
    liveness (the primary is alive, the bytes are bad), so the receive
    loop touches the payload only after stamping ``last_frame_t`` —
    otherwise a corrupting link would starve the promotion watchdog
    into a split-brain promotion against a live primary."""
    # Positional probe for the trailing CRC field: the tag byte at -9
    # AND four zero bytes at the tail (the fixed64's unused high half,
    # always zeroed by the writer). The zero-tail requirement is what
    # tells a REAL CRC field from a legacy peer's coincidence — a
    # pre-CRC envelope ends in JSON text or varint bytes, neither of
    # which produces four NULs, so a legacy HELLO whose meta JSON
    # happens to put a '9' (0x39, the tag byte) 9 bytes from the end
    # is not misread as a failing CRC and dropped forever.
    probed = (
        len(body) >= _CRC_FIELD_LEN
        and body[-_CRC_FIELD_LEN] == _CRC_TAG_BYTE
        and body[-4:] == b"\0\0\0\0"
    )
    if probed:
        # Full 64-bit compare (the high half must BE zero — masking it
        # would leave those four bytes writable by line noise), and a
        # mismatch is corrupt with NO further sniffing: deciding by
        # what the scanner sees instead would let a single flip that
        # makes a length field absorb the CRC field downgrade the
        # envelope to "legacy, unverified".
        stored = int.from_bytes(body[-8:], "little")
        if frame_fmt.crc32c(body[: -_CRC_FIELD_LEN]) != stored:
            raise EnvelopeCorrupt("replication envelope CRC mismatch")
    f = wire.scan_fields(body)
    if not probed and _F_BODY_CRC in f:
        # The scanner sees a CRC field the positional probe didn't
        # (displaced, or its zero tail was overwritten): the envelope
        # claims a checksum it cannot cash.
        raise EnvelopeCorrupt("envelope CRC field displaced")

    def _int(no: int) -> int:
        v = wire.first(f, no, 0)
        if not isinstance(v, int):
            # A rewritten tag flipped the field's wire type: acting on
            # it (an epoch compared, a seq acked) would be acting on
            # line noise.
            raise EnvelopeCorrupt(f"envelope field {no} wrong type")
        return v

    meta = wire.first(f, _F_META)
    arrays = wire.first(f, _F_ARRAYS, b"")
    if meta is not None and not isinstance(meta, bytes):
        raise EnvelopeCorrupt("envelope meta field wrong type")
    if not isinstance(arrays, bytes):
        raise EnvelopeCorrupt("envelope arrays field wrong type")
    return {
        "type": _int(_F_TYPE),
        "epoch": _int(_F_EPOCH),
        "seq": _int(_F_SEQ),
        "base_seq": _int(_F_BASE_SEQ),
        "arrays": arrays,
        "meta": json.loads(meta.decode()) if meta else {},
    }


def decode_arrays(blob: bytes) -> dict[str, np.ndarray]:
    """Verify + decode an ARRAYS payload: a current frame, or — the
    rolling-upgrade shim — a pre-frame npz blob from an un-upgraded
    peer ("v0"). Raises :class:`frame.FrameError` when the bytes fail
    verification; callers quarantine instead of merging."""
    return frame_fmt.decode_arrays(blob)


def _recv_frame(sock: socket.socket) -> dict | None:
    """One length-prefixed frame; None on clean EOF at a boundary.

    A ``socket.timeout`` may surface ONLY before the first header byte
    ("no frame yet"); once any byte of a frame has been read, the
    stream is committed and the remainder is awaited (bounded) — the
    alternative, surrendering mid-frame, would desync the
    length-prefixed stream and make the next read interpret body bytes
    as a length prefix."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    if length > _MAX_FRAME_BYTES:
        raise ReplicationError(f"frame length {length} exceeds cap")
    body = _recv_exact(sock, length, mid_frame=True)
    if body is None:
        raise ReplicationError("connection died mid-frame")
    try:
        return decode_frame(body)
    except (ValueError, KeyError, UnicodeDecodeError) as e:
        # Corrupted PROTOCOL fields (a bit flip in the tag/meta region
        # rather than the checksummed columnar payload): the stream can
        # no longer be trusted frame-aligned — end the session cleanly
        # and let the reconnect path resume, instead of letting a
        # WireError kill the thread.
        raise ReplicationError(f"undecodable frame: {e}") from e


def _recv_exact(
    sock: socket.socket, n: int, mid_frame: bool = False
) -> bytes | None:
    """Read exactly ``n`` bytes. None on clean EOF at a boundary.

    ``socket.timeout`` propagates only at a true frame boundary
    (nothing read yet, ``mid_frame`` False); once committed to a frame
    — partial buffer, or the caller says the length prefix already
    arrived — timeouts keep reading under a 30 s stall bound."""
    buf = b""
    deadline = None
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if not buf and not mid_frame:
                raise  # frame boundary: genuinely nothing to read
            now = time.monotonic()
            if deadline is None:
                deadline = now + 30.0
            if now > deadline:
                raise ReplicationError(
                    "peer stalled mid-frame"
                ) from None
            continue
        if not chunk:
            if buf or mid_frame:
                raise ReplicationError("connection died mid-frame")
            return None  # clean EOF at a frame boundary
        buf += chunk
    return buf


# -- primary side ------------------------------------------------------


class _PeerBase:
    """Per-standby acked base: the state the peer has confirmed.

    Retained ACROSS sessions (keyed by the standby's stable id) so a
    reconnecting standby that merely missed deltas resumes by merge
    instead of paying a full snapshot — the anti-entropy path.
    ``pending`` keeps the last few shipped snapshots by seq: shipping
    is pipelined (the primary does not stall on acks), so an ack
    normally lands one or two ships behind the latest and must still
    be able to advance the base to the exact state it confirmed."""

    PENDING_KEEP = 8

    __slots__ = ("arrays", "seq", "pending", "shipped_seq", "last_used")

    def __init__(self):
        self.arrays: dict[str, np.ndarray] | None = None
        self.seq = -1
        self.pending: dict[int, tuple[dict[str, np.ndarray], float]] = {}
        self.shipped_seq = -1
        self.last_used = 0.0

    def record_ship(self, seq: int, arrays: dict[str, np.ndarray]) -> None:
        self.pending[seq] = (arrays, time.monotonic())
        self.shipped_seq = seq
        while len(self.pending) > self.PENDING_KEEP:
            del self.pending[min(self.pending)]


class ReplicationPrimary:
    """Primary-side listener: snapshot bootstrap + delta shipping.

    ``snapshot_fn()`` → ``(arrays, meta)``: the CURRENT full state as
    host numpy arrays plus the meta block (offsets — confirmed only,
    the deferred-confirmation rule — service names, clock, config
    fingerprint). It must be safe to call from this module's session
    threads (the daemon snapshots under the pipeline's dispatch lock).
    """

    MAX_PEERS = 4  # retained acked bases (LRU beyond this)

    def __init__(
        self,
        snapshot_fn: Callable[[], tuple[dict, dict]],
        fence: EpochFence,
        host: str = "127.0.0.1",
        port: int = 0,
        interval_s: float = 1.0,
        on_fenced: Callable[[int], None] | None = None,
    ):
        self.snapshot_fn = snapshot_fn
        self.fence = fence
        self.interval_s = interval_s
        self.on_fenced = on_fenced
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._peers: dict[str, _PeerBase] = {}
        self._peers_lock = threading.Lock()
        self._stop = False
        self._sessions: list[socket.socket] = []
        self._sessions_lock = threading.Lock()
        # Stats (the anomaly_replication_* exports + replbench).
        self.deltas_shipped = 0
        self.snapshots_shipped = 0
        self.acks_received = 0
        self.frames_corrupt = 0  # corrupt HELLO/ACK envelopes skipped
        self.fenced_events = 0
        self.last_ack_t: float = 0.0
        self.ack_lag_s: deque = deque(maxlen=1024)  # ship→ack round trips
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._acceptor = threading.Thread(
            target=self._accept_loop, name="replication-accept", daemon=True
        )

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        self._acceptor.start()

    def alive(self) -> bool:
        return self._acceptor.is_alive() and not self._stop

    def stop(self) -> None:
        self._stop = True
        try:
            self._sock.close()
        except OSError:
            pass
        with self._sessions_lock:
            sessions, self._sessions = self._sessions, []
        for s in sessions:
            try:
                s.close()
            except OSError:
                pass
        self._acceptor.join(timeout=2.0)

    def kill(self) -> None:
        """Abrupt death (tests/replbench): RST every session, no FIN —
        what a SIGKILLed primary looks like from the standby."""
        self._stop = True
        with self._sessions_lock:
            sessions, self._sessions = self._sessions, []
        for s in sessions + [self._sock]:
            try:
                s.setsockopt(
                    socket.SOL_SOCKET, socket.SO_LINGER,
                    struct.pack("ii", 1, 0),
                )
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    # -- session loop ---------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            with self._sessions_lock:
                self._sessions.append(conn)
            threading.Thread(
                target=self._session_guarded, args=(conn,),
                name="replication-session", daemon=True,
            ).start()

    def _session_guarded(self, conn: socket.socket) -> None:
        try:
            self._session(conn)
        except Exception as e:  # noqa: BLE001 — a session fault (incl.
            # a raising snapshot_fn) ends THIS session; the standby
            # reconnects and resumes from its acked base.
            log.warning("replication session crashed: %s", e)

    def _next_seq(self) -> int:
        with self._seq_lock:
            self._seq += 1
            return self._seq

    def _peer(self, peer_id: str) -> _PeerBase:
        with self._peers_lock:
            peer = self._peers.get(peer_id)
            if peer is None:
                peer = self._peers[peer_id] = _PeerBase()
            peer.last_used = time.monotonic()
            while len(self._peers) > self.MAX_PEERS:
                oldest = min(self._peers, key=lambda k: self._peers[k].last_used)
                del self._peers[oldest]
        return peer

    def _session(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(max(self.interval_s, 0.05))
            hello = None
            try:
                hello = _recv_frame(conn)
            except EnvelopeCorrupt:
                # A corrupt HELLO: drop the session; the standby's
                # reconnect sends a fresh (hopefully clean) one.
                self.frames_corrupt += 1
                return
            except (socket.timeout, OSError, ReplicationError):
                return
            if hello is None or hello["type"] != HELLO:
                return
            if self._observe_peer_epoch(hello["epoch"]):
                # A peer already past our epoch: tell it nothing; we are
                # the stale side. (FENCED is the standby's reply shape;
                # a fenced primary simply stops shipping.)
                return
            peer_cfg = hello["meta"].get("config")
            if peer_cfg is not None and not self._config_compatible(peer_cfg):
                # A geometry-mismatched standby would replicate happily
                # and detonate only at promotion — the one moment there
                # is no other replica. Refuse loudly at attach instead.
                log.error(
                    "replication HELLO rejected: standby config %s does "
                    "not match primary's — fix the standby's detector "
                    "geometry before attaching", peer_cfg,
                )
                return
            peer_id = hello["meta"].get("standby_id", "anon")
            peer = self._peer(peer_id)
            applied = int(hello["meta"].get("applied_seq", -1))
            if peer.arrays is None or peer.seq != applied or applied < 0:
                # No resumable base for this standby: full bootstrap.
                # (A matching base means the standby merely missed
                # deltas — the next DELTA's aggregate vs that base IS
                # the anti-entropy merge, no snapshot needed.)
                if not self._ship_snapshot(conn, peer):
                    return
            # Steady state: drain responses for one interval, then ship
            # (drain-first so the bootstrap/resync ack lands before the
            # next ship decision — otherwise every interval without an
            # acked base would re-ship a full snapshot).
            t_ship = time.monotonic()
            while not self._stop:
                deadline = t_ship + self.interval_s
                while not self._stop:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    conn.settimeout(remaining)
                    try:
                        frame = _recv_frame(conn)
                    except socket.timeout:
                        break
                    except EnvelopeCorrupt:
                        # A corrupt ACK must neither kill the session
                        # nor — the real hazard — have its (possibly
                        # rewritten) epoch observed: skip exactly one
                        # frame, keep draining.
                        self.frames_corrupt += 1
                        continue
                    except (OSError, ReplicationError):
                        return
                    if frame is None:
                        return
                    if not self._handle_response(frame, peer, conn):
                        return
                if self._stop:
                    return
                t_ship = time.monotonic()
                if not self._ship_delta(conn, peer):
                    return
        finally:
            with self._sessions_lock:
                if conn in self._sessions:
                    self._sessions.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _config_compatible(self, peer_cfg) -> bool:
        """Compare the standby's config fingerprint against ours (the
        snapshot_fn meta's ``config``), normalized through JSON — the
        wire turns tuples into lists. An absent fingerprint on either
        side (bare-component tests, older peers) is accepted."""
        try:
            _arrays, meta = self.snapshot_fn()
        except Exception:  # noqa: BLE001 — can't snapshot now: let the
            return True  # session proceed; shipping will retry/fail
        ours = meta.get("config")
        if not ours or not peer_cfg:
            return True
        norm = lambda c: json.loads(json.dumps(c))  # noqa: E731
        return norm(ours) == norm(peer_cfg)

    def _observe_peer_epoch(self, epoch: int) -> bool:
        """Record a peer epoch; True (and fire on_fenced) when newer."""
        if epoch > self.fence.epoch:
            self.fence.observe(epoch)
            self.fenced_events += 1
            log.error(
                "replication peer at epoch %d > ours %d: we are fenced",
                epoch, self.fence.epoch,
            )
            if self.on_fenced is not None:
                try:
                    self.on_fenced(epoch)
                except Exception:  # noqa: BLE001 — callback must not
                    pass  # kill the session thread mid-teardown
            return True
        return False

    def _ship_snapshot(self, conn: socket.socket, peer: _PeerBase) -> bool:
        arrays, meta = self.snapshot_fn()
        seq = self._next_seq()
        try:
            conn.sendall(encode_frame(
                SNAPSHOT, self.fence.epoch, seq=seq, arrays=arrays, meta=meta
            ))
        except OSError:
            return False
        # A snapshot IS its own acked base candidate: the standby
        # replaces wholesale, so the ack rule below treats it like a
        # shipped delta.
        peer.record_ship(seq, arrays)
        self.snapshots_shipped += 1
        return True

    def _ship_delta(self, conn: socket.socket, peer: _PeerBase) -> bool:
        if peer.arrays is None:
            # Bootstrap not yet acked. Give in-flight snapshot ships a
            # few intervals of grace before re-shipping — a full-state
            # frame simply takes longer than a delta interval to apply
            # and ack, and re-snapshotting on every tick would churn
            # the link exactly when it is trying to catch up.
            in_flight = [t for _arr, t in peer.pending.values()]
            if in_flight and (
                time.monotonic() - max(in_flight) < 3 * self.interval_s
            ):
                return True  # wait for the ack; nothing shipped
            return self._ship_snapshot(conn, peer)
        arrays, meta = self.snapshot_fn()
        seq = self._next_seq()
        payload: dict[str, np.ndarray] = {}
        for key, cur in arrays.items():
            if key in ADD_KEYS:
                payload[key] = cur - peer.arrays[key]
            else:
                payload[key] = cur  # MAX_KEYS + replace-latest block
        # Rotation detection (see module docstring): max-merge is only
        # a valid reconciliation while registers are monotone vs the
        # peer's acked base; a window rotation lowers them, and that
        # frame must replace instead.
        meta = dict(meta)
        meta["hll_monotone"] = bool(all(
            (arrays[k] >= peer.arrays[k]).all()
            for k in MAX_KEYS if k in peer.arrays
        ))
        try:
            conn.sendall(encode_frame(
                DELTA, self.fence.epoch, seq=seq, base_seq=peer.seq,
                arrays=payload, meta=meta,
            ))
        except OSError:
            return False
        peer.record_ship(seq, arrays)
        self.deltas_shipped += 1
        return True

    def _handle_response(
        self, frame: dict, peer: _PeerBase, conn: socket.socket
    ) -> bool:
        if self._observe_peer_epoch(frame["epoch"]):
            return False
        if frame["type"] == FENCED:
            # Redundant with the epoch check, but a FENCED frame at an
            # equal epoch is protocol confusion worth ending the session
            # over.
            return False
        if frame["type"] != ACK:
            return True
        self.acks_received += 1
        self.last_ack_t = time.monotonic()
        acked = frame["seq"]
        hit = peer.pending.get(acked)
        if hit is not None:
            arrays, shipped_at = hit
            peer.arrays = arrays
            peer.seq = acked
            # Drop everything the ack supersedes (acks are monotone).
            for s in [s for s in peer.pending if s <= acked]:
                del peer.pending[s]
            self.ack_lag_s.append(time.monotonic() - shipped_at)
        elif acked == peer.seq:
            pass  # standby missed the ship; next delta reuses the base
        else:
            # An ack we can't map to a retained snapshot (older than
            # the pending window, or from before a primary restart):
            # resync with a full snapshot rather than guess.
            log.warning(
                "replication ack %d matches neither base %d nor any "
                "pending ship (last %d): full resync",
                acked, peer.seq, peer.shipped_seq,
            )
            peer.pending.clear()
            return self._ship_snapshot(conn, peer)
        return True

    # -- introspection --------------------------------------------------

    def lag_seconds(self) -> float:
        """Seconds since the last acked delta (0 before any ack —
        a just-started primary with no standby is not 'lagging')."""
        if not self.last_ack_t:
            return 0.0
        return max(time.monotonic() - self.last_ack_t, 0.0)

    def stats(self) -> dict:
        return {
            "deltas_shipped": self.deltas_shipped,
            "snapshots_shipped": self.snapshots_shipped,
            "acks_received": self.acks_received,
            "frames_corrupt": self.frames_corrupt,
            "fenced_events": self.fenced_events,
            "lag_s": self.lag_seconds(),
            "ack_lag_p99_ms": (
                float(np.percentile(np.asarray(self.ack_lag_s), 99) * 1e3)
                if self.ack_lag_s else None
            ),
        }


# -- standby side ------------------------------------------------------


class ReplicationStandby:
    """Standby-side client: bootstrap, apply, watchdog state.

    Maintains a host-numpy mirror of the primary's state (``arrays``)
    plus the latest meta block; promotion writes the mirror onto the
    card (``models.detector.state_from_numpy``). Applying is pure monoid algebra —
    max for HLL, add for the CMS aggregate delta, replace for the
    latest block — so a standby that missed any number of deltas is
    correct again one frame after the link heals."""

    RECONNECT_BACKOFF_S = 0.5

    def __init__(
        self,
        target: str,
        fence: EpochFence,
        config_fingerprint: list | None = None,
        standby_id: str | None = None,
        silence_reconnect_s: float = 2.0,
    ):
        host, _, port = target.rpartition(":")
        self.addr = (host or "127.0.0.1", int(port))
        self.fence = fence
        self.config_fingerprint = config_fingerprint
        self.standby_id = standby_id or uuid.uuid4().hex
        # Session-level silence watchdog: a healthy primary ships every
        # interval, so a session that hears NOTHING for this long is a
        # half-open connection (the blackhole shape — the peer died
        # without an RST reaching us) and must be abandoned for a
        # reconnect. Distinct from the daemon's PROMOTION watchdog,
        # which keeps its own (longer) timeout on the same clock.
        self.silence_reconnect_s = silence_reconnect_s
        self.arrays: dict[str, np.ndarray] = {}
        self.meta: dict = {}
        self.applied_seq = -1
        self.deltas_applied = 0
        self.snapshots_applied = 0
        self.frames_rejected = 0  # base mismatch (would double-count)
        # Deltas refused for keyspace-generation drift (the eviction
        # plane recycled intern ids between our base and the frame):
        # refusal leaves applied_seq put, the stale ack triggers the
        # primary's full resync, and the snapshot adopts the new
        # generation wholesale — self-healing by the existing path.
        self.frames_generation_drift = 0
        # Frames whose columnar payload failed verification (corrupt
        # link / bit rot): quarantined — never merged — and the ACK
        # re-asserts our last GOOD position, so the primary reships
        # against the retained base. The daemon exports this as
        # anomaly_frame_corrupt_total{hop="replication"}.
        self.frames_corrupt = 0
        # Intact frames from a NEWER format version (upgrade-order
        # problem, not corruption — never quarantined).
        self.frames_version_skew = 0
        self.fenced_sent = 0
        self.last_frame_t: float = time.monotonic()
        self._have_state = threading.Event()
        self._lock = threading.Lock()
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="replication-standby", daemon=True
        )

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        self._thread.start()

    def alive(self) -> bool:
        return self._thread.is_alive() and not self._stop

    def stop(self) -> None:
        self._stop = True
        self._thread.join(timeout=2.0)

    def retarget(self, target: str) -> None:
        """Re-point the mirror at a NEW primary (the ring-successor
        changed after an adoption/resize): end the session, drop the
        mirrored state — it belongs to the OLD peer's keyspace, and a
        merge against it would double-count — and dial the new
        address. ``applied_seq`` resets to -1, so the new primary
        leads with a full SNAPSHOT after HELLO and the mirror is
        correct again one frame after the dial lands."""
        self._stop = True
        if self._thread.ident is not None:
            self._thread.join(timeout=2.0)
        host, _, port = target.rpartition(":")
        with self._lock:
            self.addr = (host or "127.0.0.1", int(port))
            self.arrays = {}
            self.meta = {}
            self.applied_seq = -1
        self._have_state.clear()
        self.last_frame_t = time.monotonic()
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="replication-standby", daemon=True
        )
        self._thread.start()

    def wait_for_state(self, timeout: float = 10.0) -> bool:
        """Block until the first snapshot landed (tests/bootstrap)."""
        return self._have_state.wait(timeout)

    def seconds_since_frame(self) -> float:
        """The promotion watchdog's clock: time since ANY frame (or
        since start) — a quiet-but-alive primary still ships deltas
        every interval, so silence IS the death signal."""
        return time.monotonic() - self.last_frame_t

    def snapshot(self) -> tuple[dict[str, np.ndarray], dict]:
        """Mirror copy for promotion (and for a promoted standby's own
        ReplicationPrimary snapshot_fn until the live detector owns the
        state)."""
        with self._lock:
            return (
                {k: np.array(v, copy=True) for k, v in self.arrays.items()},
                dict(self.meta),
            )

    # -- client loop ----------------------------------------------------

    def _run(self) -> None:
        while not self._stop:
            try:
                self._session()
            except Exception as e:  # noqa: BLE001 — the loop IS the
                # supervisor here: any transport/protocol fault becomes
                # a bounded-backoff reconnect, never a dead thread.
                log.debug("replication session ended: %s", e)
            if self._stop:
                return
            time.sleep(self.RECONNECT_BACKOFF_S)

    def _session(self) -> None:
        sock = socket.create_connection(self.addr, timeout=5.0)
        try:
            sock.sendall(encode_frame(
                HELLO, self.fence.epoch,
                meta={
                    "standby_id": self.standby_id,
                    "applied_seq": self.applied_seq,
                    "config": self.config_fingerprint,
                },
            ))
            sock.settimeout(min(1.0, self.silence_reconnect_s / 2))
            session_started = time.monotonic()
            while not self._stop:
                try:
                    frame = _recv_frame(sock)
                except EnvelopeCorrupt:
                    # A corrupt envelope still PROVES the primary is
                    # alive and framing correctly — credit liveness
                    # (else a lossy-but-alive link starves the
                    # promotion watchdog into split-brain), count, and
                    # skip exactly this frame. None of its fields —
                    # epoch included — may be acted on.
                    self.frames_corrupt += 1
                    self.last_frame_t = time.monotonic()
                    continue
                except socket.timeout:
                    quiet_since = max(self.last_frame_t, session_started)
                    if (
                        time.monotonic() - quiet_since
                        > self.silence_reconnect_s
                    ):
                        raise ReplicationError(
                            "session silent past the watchdog; "
                            "reconnecting"
                        ) from None
                    continue
                if frame is None:
                    return
                self.last_frame_t = time.monotonic()
                if frame["epoch"] < self.fence.epoch:
                    # Stale primary (we promoted past it, or saw a newer
                    # one): refuse the frame, teach it the epoch.
                    self.fenced_sent += 1
                    sock.sendall(encode_frame(FENCED, self.fence.epoch))
                    continue
                self.fence.observe(frame["epoch"])
                if frame["type"] == SNAPSHOT:
                    self._apply_snapshot(frame)
                elif frame["type"] == DELTA:
                    self._apply_delta(frame)
                else:
                    continue
                sock.sendall(encode_frame(
                    ACK, self.fence.epoch, seq=self.applied_seq
                ))
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _verified_arrays(self, frame: dict) -> dict[str, np.ndarray] | None:
        """Verify+decode a frame's columnar payload; None = quarantined.

        The corruption boundary: a payload that fails its checksums is
        counted, written aside (when ANOMALY_FRAME_QUARANTINE_DIR is
        set) and NEVER merged — the subsequent ACK of our unchanged
        ``applied_seq`` is the NACK that makes the primary reship
        against the retained base, so a clean retransmit converges
        without any extra protocol."""
        blob = frame["arrays"]
        try:
            return decode_arrays(blob)
        except frame_fmt.FrameVersionError as e:
            # An upgrade-order problem, NOT bad bytes (the frame is
            # intact — its version is simply outside our window):
            # never quarantined or counted as corruption. Not applied
            # either — the stale ACK tells the primary we are behind,
            # and the operator signal is this log + the skew counter,
            # not a "bad hardware" panel.
            self.frames_version_skew += 1
            log.error(
                "replication frame seq %d from a NEWER format (%s) — "
                "upgrade this standby; not applied",
                frame["seq"], e,
            )
            return None
        except frame_fmt.FrameError as e:
            self.frames_corrupt += 1
            path = frame_fmt.quarantine(blob, "replication")
            log.error(
                "replication frame seq %d failed verification (%s)%s — "
                "quarantined, not applied; acking last good seq %d",
                frame["seq"], e,
                f"; evidence at {path}" if path else "",
                self.applied_seq,
            )
            return None

    def _apply_snapshot(self, frame: dict) -> None:
        arrays = self._verified_arrays(frame)
        if arrays is None:
            return
        with self._lock:
            self.arrays = arrays
            self.meta = frame["meta"]
            self.applied_seq = frame["seq"]
        self.snapshots_applied += 1
        self._have_state.set()

    def _apply_delta(self, frame: dict) -> None:
        arrays = self._verified_arrays(frame)
        if arrays is None:
            return
        with self._lock:
            if frame["base_seq"] != self.applied_seq or not self.arrays:
                # Applying an add-delta against the wrong base would
                # double-count CMS rows; ack our real position instead
                # (the primary re-bases or resyncs).
                self.frames_rejected += 1
                return
            ours = int((self.meta or {}).get("generation") or 0)
            theirs = int(
                (frame["meta"] or {}).get("generation") or 0
            )
            if theirs != ours:
                # Keyspace generation drift: the primary's evictor
                # recycled intern ids since our mirror's base — a row-
                # wise merge could attribute an old key's registers to
                # the id's NEW owner. Refuse; the stale ack makes the
                # primary ship a full snapshot, which replaces
                # wholesale and adopts the new generation.
                self.frames_generation_drift += 1
                self.frames_rejected += 1
                return
            hll_monotone = frame["meta"].get("hll_monotone", True)
            for key, inc in arrays.items():
                if key in MAX_KEYS and hll_monotone:
                    # hll_merge: elementwise max (ops/hll.py:94) — the
                    # commutative-idempotent half of the monoid pair.
                    self.arrays[key] = np.maximum(self.arrays[key], inc)
                elif key in ADD_KEYS:
                    # cms_merge: elementwise add (ops/cms.py:301) over
                    # the aggregate delta vs OUR acked base (rotation
                    # clears arrive as negative entries).
                    self.arrays[key] = self.arrays[key] + inc
                else:
                    # Replace-latest block — and the rare rotation-
                    # spanning HLL frame (hll_monotone: false).
                    self.arrays[key] = inc
            self.meta = frame["meta"]
            self.applied_seq = frame["seq"]
        self.deltas_applied += 1

    def stats(self) -> dict:
        return {
            "deltas_applied": self.deltas_applied,
            "snapshots_applied": self.snapshots_applied,
            "frames_rejected": self.frames_rejected,
            "frames_generation_drift": self.frames_generation_drift,
            "frames_corrupt": self.frames_corrupt,
            "frames_version_skew": self.frames_version_skew,
            "fenced_sent": self.fenced_sent,
            "applied_seq": self.applied_seq,
            "seconds_since_frame": self.seconds_since_frame(),
        }
