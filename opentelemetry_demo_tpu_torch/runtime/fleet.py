"""N-way sharded detector fleet: the robustness tier above hot standby.

Deployment so far was 1 primary + 1 hot standby — one detector process
was a single point of total blindness. This module partitions the
keyspace across N detector shards and makes losing ANY shard brown out
only its keyspace slice:

- **Consistent-hash ring** (:class:`HashRing`): (tenant/service) keys
  → shard members via vnode points hashed with a process-stable
  64-bit digest (``blake2b`` — NEVER Python ``hash()``, whose
  per-process randomization would give every restart a different
  placement). N-1/N of the keyspace does not move when one member
  joins or leaves; the fleet suite property-pins balance, minimal
  movement and cross-process determinism.
- **Membership + liveness** (:class:`FleetMembership`): heartbeat
  table over the peers with two-edge hysteresis — a peer is declared
  dead only after ``dead_after_s`` of silence AND a failed health
  double-check (the replication watchdog's primary-health pattern: a
  compile-stalled-but-serving shard is NOT dead, so CI suite load
  cannot trigger a spurious reshard), and a dead peer rejoins only
  after ``rejoin_after_s`` of sustained heartbeats. Every membership
  change spends a token from a reshard budget
  (:class:`~.remediation.TokenBucket`, the admission and remediation guardrail
  construction): a flapping shard exhausts the bucket and the ring
  FREEZES in its last state — reshards refused and counted, the
  keyspace never thrashes.
- **Reshard merge** (:func:`merge_shard_arrays`): a dead shard's key
  range is reassigned to survivors by shipping the victim's latest
  replicated frame to the inheriting shard(s) and monoid-merging it
  in — HLL registers max-merge, CMS/span-total add-merge, the
  victim's per-service head rows (EWMA/CUSUM) copied over the
  survivor's virgin rows. Disjoint keyspaces make the merge bit-exact
  by construction (the replication link's anti-entropy property, property-pinned
  again here through the reshard path) — PROVIDED the shards share
  one interned service-id table: CMS cells fold the service id into
  the key hash, so fleet mode pre-interns ``ANOMALY_FLEET_SERVICES``
  in the same order on every shard, and :func:`merge_shard_arrays`
  refuses tables that drifted instead of mis-attributing cells.
- **Per-tenant namespaces**: ring keys are :func:`shard_key`
  ``tenant/service`` (``ANOMALY_FLEET_TENANTS`` maps services to
  tenants); the per-tenant admission quota itself lives in
  ``runtime.pipeline`` (folded into the backpressure ladder) and
  sheds one noisy tenant's rows alone.

The scatter-gather READ tier over the shard query planes lives in
``runtime.aggregator`` (it speaks only HTTP to shards — never detector
state). ``runtime.replbench --fleet`` is the chaos drill: SIGKILL a
shard under live load, measure ``shard_reshard_ttd_s``, pin the
post-reshard answers bit-exact against an unkilled witness fleet.

Everything here is stdlib + numpy — no torch import, so the membership
thread and the aggregator tier never pay device initialization.
"""

from __future__ import annotations

import hashlib
import threading
import time
from bisect import bisect_left
from typing import Callable, Iterable

import numpy as np

# The reshard budget reuses remediation's TokenBucket VERBATIM — the
# "flap-proof by construction" guardrail is one implementation, not
# three lookalikes that could drift.
from .remediation import TokenBucket
from .tensorize import EVICTED_SLOT

DEFAULT_TENANT = "default"

# Peer liveness states (the membership table's vocabulary).
PEER_ALIVE = "alive"
PEER_DEAD = "dead"

# Merge policy per state array (the sketch monoids replication proved
# bit-exact through missed deltas; reshard reuses them unchanged).
MERGE_MAX = ("hll_bank",)          # HLL registers: max-merge
MERGE_ADD = ("cms_bank", "span_total")  # CMS counters / span totals: add
# Per-service head rows (EWMA/CUSUM baselines; [S, ...] leading axis):
# the victim's rows copy over the inheriting survivor's virgin rows —
# keyspaces are disjoint, so the survivor never observed those
# services. step_idx (scalar) takes the max so the merged seq cursor
# never regresses.
MERGE_HEAD_ROWS = (
    "lat_mean", "lat_var", "err_mean", "rate_mean", "rate_var",
    "card_mean", "card_var", "obs_batches", "obs_windows", "cusum",
)


def key_hash64(key: str) -> int:
    """Process-stable 64-bit hash of a ring key.

    blake2b, not ``hash()``: CPython randomizes str hashing per process
    (PYTHONHASHSEED), and a ring whose placement changes across
    restarts would reshard the whole keyspace on every deploy. The
    fleet suite pins placement equality across processes with
    different hash seeds."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(),
        "big",
    )


def shard_key(service: str, tenant: str = DEFAULT_TENANT) -> str:
    """THE ring key for one (service × tenant) keyspace cell."""
    return f"{tenant}/{service}"


def tenant_of(service: str, tenant_map: dict[str, str]) -> str:
    """Service → tenant under the ANOMALY_FLEET_TENANTS map ('*' is
    the default for unlisted services; no map = tenant 'default')."""
    return tenant_map.get(
        service, tenant_map.get("*", DEFAULT_TENANT)
    )


class HashRing:
    """Consistent-hash ring over shard member ids.

    ``vnodes`` virtual points per member smooth the balance (more
    vnodes = tighter spread at O(members × vnodes) rebuild cost).
    Deterministic by construction: points come from
    :func:`key_hash64`, so every process — and every restart — builds
    the identical ring from the identical member set.
    """

    def __init__(
        self,
        members: Iterable[str],
        vnodes: int = 128,
        adopted: dict[str, str] | None = None,
    ):
        self.vnodes = max(int(vnodes), 1)
        self._members: set[str] = set()
        self._adopted: dict[str, str] = dict(adopted or {})
        self._points: list[int] = []
        self._owners: list[str] = []
        self._lock = threading.Lock()
        for m in members:
            self._members.add(str(m))
        self._rebuild()

    def _heir_of(self, victim: str) -> str | None:
        """Resolve an adoption chain to a LIVE heir (a heir that died
        and was itself adopted hands the whole arc onward)."""
        seen = set()
        cur = victim
        while cur in self._adopted and cur not in seen:
            seen.add(cur)
            cur = self._adopted[cur]
        return cur if cur in self._members else None

    def _rebuild(self) -> None:
        pairs = sorted(
            (key_hash64(f"{member}#{v}"), owner)
            for member, owner in (
                [(m, m) for m in self._members]
                + [
                    (v, self._heir_of(v))
                    for v in self._adopted
                    if v not in self._members
                ]
            )
            if owner is not None
            for v in range(self.vnodes)
        )
        self._points = [p for p, _ in pairs]
        self._owners = [m for _, m in pairs]

    def members(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._members))

    def adopted(self) -> dict[str, str]:
        """victim → heir arc transfers currently in force (the block
        /healthz publishes so a refreshing aggregator can rebuild the
        IDENTICAL ring, adoption arcs included)."""
        with self._lock:
            return dict(self._adopted)

    def version(self) -> int:
        """Stable ring-content digest: equal member sets (and vnode
        counts, and adoption arcs) hash equal in every process — the
        value /healthz and the aggregator compare to detect a ring
        split. The adoption suffix only appears when arcs are in
        force, so pre-adoption rings keep their historical digests."""
        with self._lock:
            text = ",".join(sorted(self._members)) + f"|{self.vnodes}"
            if self._adopted:
                text += "|" + ",".join(
                    f"{v}>{h}" for v, h in sorted(self._adopted.items())
                )
            return key_hash64(text)

    def add(self, member: str) -> bool:
        with self._lock:
            changed = member in self._adopted
            self._adopted.pop(member, None)  # rejoin reclaims the arc
            if member in self._members:
                if changed:
                    self._rebuild()
                return changed
            self._members.add(member)
            self._rebuild()
            return True

    def remove(self, member: str) -> bool:
        with self._lock:
            if member not in self._members:
                return False
            self._members.discard(member)
            self._rebuild()
            return True

    def adopt(self, victim: str, heir: str) -> bool:
        """Transfer ``victim``'s ENTIRE arc to ``heir`` and drop it
        from membership: unlike :meth:`remove` (which redistributes
        the victim's vnode arcs across all survivors by hash), every
        key the victim owned now belongs to the one shard that holds
        its replicated frame — the ownership shape that makes
        automatic frame adoption answer bit-exact reads."""
        with self._lock:
            if victim not in self._members or heir == victim:
                return False
            if heir not in self._members:
                return False
            self._members.discard(victim)
            self._adopted[victim] = heir
            self._rebuild()
            return True

    def owner(self, key: str) -> str:
        """The member owning ``key`` (first vnode point clockwise)."""
        with self._lock:
            if not self._points:
                raise RuntimeError("empty ring: no members")
            i = bisect_left(self._points, key_hash64(key))
            if i == len(self._points):
                i = 0  # wrap
            return self._owners[i]

    def owner_of(self, service: str, tenant: str = DEFAULT_TENANT) -> str:
        return self.owner(shard_key(service, tenant))

    def assignments(self, keys: Iterable[str]) -> dict[str, str]:
        """key → owning member for a key set (one lock round)."""
        return {k: self.owner(k) for k in keys}

    def spread(self, keys: Iterable[str]) -> dict[str, int]:
        """member → owned-key count (the balance the suite pins)."""
        out: dict[str, int] = {m: 0 for m in self.members()}
        for k in keys:
            out[self.owner(k)] += 1
        return out


def ring_successor(members: Iterable[str], self_id: str) -> str | None:
    """The member after ``self_id`` in sorted member order (wrapping)
    — the peer whose replication stream this shard mirrors so it can
    adopt the keyspace if that peer dies. Deterministic from the
    member list alone: every shard computes the same pairing with no
    coordination. ``None`` when alone (nothing to mirror)."""
    ordered = sorted({str(m) for m in members})
    if self_id not in ordered or len(ordered) < 2:
        return None
    i = ordered.index(self_id)
    return ordered[(i + 1) % len(ordered)]


def ring_heir(members: Iterable[str], victim: str) -> str | None:
    """The survivor that adopts ``victim``'s arc: the member whose
    :func:`ring_successor` is (was) the victim — its predecessor in
    sorted order over the full member set. Every member computes the
    identical heir from the identical list, so the adoption lands on
    exactly one shard. ``None`` when no survivor exists."""
    full = sorted({str(m) for m in members} | {victim})
    if len(full) < 2:
        return None
    i = full.index(victim)
    return full[i - 1]


# -- reshard state merge ------------------------------------------------


class ShardMergeError(RuntimeError):
    """A reshard frame that CANNOT merge bit-exactly (drifted service
    tables / mismatched geometry) — refused, never mis-attributed."""


def service_row_mask(
    src_names: list[str],
    dst_names: list[str],
    num_rows: int,
    owned: Iterable[str] | None = None,
) -> np.ndarray:
    """bool[num_rows] of head rows to adopt from a victim frame.

    The tables must AGREE on every overlapping position (the shared
    ``ANOMALY_FLEET_SERVICES`` pre-intern contract): CMS cells bake
    the service id into the key hash, so a drifted table cannot be
    fixed up after the fact — it is refused.

    ``owned``: restrict adoption to these service names (the victim's
    keyspace slice); None adopts every row the victim ever interned.
    """
    overlap = min(len(src_names), len(dst_names))
    for i in range(overlap):
        if src_names[i] != dst_names[i]:
            raise ShardMergeError(
                f"service tables drifted at id {i}: "
                f"{src_names[i]!r} != {dst_names[i]!r} — shards must "
                "share ANOMALY_FLEET_SERVICES to exchange frames"
            )
    mask = np.zeros(num_rows, dtype=bool)
    allowed = None if owned is None else set(owned)
    for i, name in enumerate(src_names):
        if i >= num_rows:
            break
        if name == EVICTED_SLOT:
            continue  # freed slot: no service owns the row anymore
        if allowed is None or name in allowed:
            mask[i] = True
    return mask


def merge_shard_arrays(
    dst: dict,
    src: dict,
    head_rows: np.ndarray | None = None,
    *,
    dst_generation: int | None = None,
    src_generation: int | None = None,
) -> dict:
    """Monoid-merge a victim shard's replicated arrays into a
    survivor's — the reshard adoption step.

    HLL banks max-merge and CMS banks / span totals add-merge (exact
    for disjoint keyspaces: merged sketch == sketch of the union
    stream, the anti-entropy property); per-service head rows in ``head_rows``
    (bool [S]) copy from the victim — the survivor's rows for a
    keyspace it never observed are virgin. Returns NEW arrays; neither
    input is mutated (the caller swaps under its own dispatch lock).

    ``dst_generation``/``src_generation`` extend the drift-refusal
    contract to the key lifecycle plane: a keyspace eviction sweep
    recycles intern ids behind a generation bump, so two frames whose
    generations disagree may use the SAME id for DIFFERENT services —
    merging them would mis-attribute sketch rows with no way to tell.
    When both are provided they must match; ``None`` (a frame minted
    before the lifecycle plane) skips the check for compatibility.
    """
    if (
        dst_generation is not None
        and src_generation is not None
        and int(dst_generation) != int(src_generation)
    ):
        raise ShardMergeError(
            f"keyspace generation drift: dst gen {dst_generation} vs "
            f"src gen {src_generation} — recycled intern ids cannot "
            "merge across an eviction sweep"
        )
    out = {k: np.array(v, copy=True) for k, v in dst.items()}
    for name in MERGE_MAX:
        if name in out and name in src:
            a, b = out[name], np.asarray(src[name])
            if a.shape != b.shape:
                raise ShardMergeError(
                    f"{name} geometry mismatch {a.shape} vs {b.shape}"
                )
            np.maximum(a, b, out=a)
    for name in MERGE_ADD:
        if name in out and name in src:
            a, b = out[name], np.asarray(src[name])
            if a.shape != b.shape:
                raise ShardMergeError(
                    f"{name} geometry mismatch {a.shape} vs {b.shape}"
                )
            a += b.astype(a.dtype, copy=False)
    if head_rows is not None:
        for name in MERGE_HEAD_ROWS:
            if name not in out or name not in src:
                continue
            a, b = out[name], np.asarray(src[name])
            if a.shape != b.shape:
                raise ShardMergeError(
                    f"{name} geometry mismatch {a.shape} vs {b.shape}"
                )
            rows = head_rows[: a.shape[0]]
            a[rows] = b[rows]
    if "step_idx" in out and "step_idx" in src:
        out["step_idx"] = np.maximum(
            np.asarray(out["step_idx"]), np.asarray(src["step_idx"])
        )
    return out


# -- membership + guardrailed reshard -----------------------------------


class _PeerState:
    __slots__ = (
        "last_beat", "alive", "beats_since", "in_ring",
    )

    def __init__(self, now: float):
        self.last_beat = now
        self.alive = True
        self.beats_since = now  # start of the current sustained-beat run
        self.in_ring = True


class FleetMembership:
    """Heartbeat liveness + hysteresis + budgeted ring membership.

    Drive it with ``observe(peer)`` on every successful heartbeat and
    ``tick()`` on a cadence; it returns the reshard events it APPLIED
    to the ring (leave/join), already guardrailed:

    - down edge: silence > ``dead_after_s`` AND the optional
      ``health_check(peer)`` double-check fails (a serving-but-slow
      shard gets its watchdog credited instead — the flake guard);
    - up edge: sustained beats for ``rejoin_after_s``;
    - every applied change spends a reshard-budget token; an empty
      bucket freezes the ring (refusals counted, state unchanged).
    """

    def __init__(
        self,
        self_id: str,
        peers: Iterable[str],
        *,
        vnodes: int = 128,
        dead_after_s: float = 3.0,
        rejoin_after_s: float = 5.0,
        reshard_budget: int = 4,
        reshard_refill_s: float = 60.0,
        health_check: Callable[[str], bool] | None = None,
        on_reshard: Callable[[dict], None] | None = None,
        adoptive: bool = False,
    ):
        self.self_id = str(self_id)
        peer_ids = [str(p) for p in peers if str(p) != self.self_id]
        # Adoptive mode: a declared-dead peer's arc TRANSFERS whole to
        # its deterministic heir (ring.adopt) instead of rehashing
        # across all survivors — the heir is the shard mirroring the
        # victim's replication stream, so ownership lands exactly
        # where the replicated frame already lives.
        self.adoptive = bool(adoptive)
        self.ring = HashRing([self.self_id, *peer_ids], vnodes=vnodes)
        self.dead_after_s = float(dead_after_s)
        self.rejoin_after_s = float(rejoin_after_s)
        self._health_check = health_check
        self._on_reshard = on_reshard
        self._bucket = TokenBucket(reshard_budget, reshard_refill_s)
        self._lock = threading.Lock()
        now = time.monotonic()
        self._peers: dict[str, _PeerState] = {
            p: _PeerState(now) for p in peer_ids
        }
        self.reshards_total = 0
        self.reshards_refused = 0
        # One refusal is counted per WANTED transition, not per tick —
        # a frozen ring under a still-dead peer logs once, not 100 Hz.
        self._refused_pending: set[str] = set()

    # -- heartbeats -----------------------------------------------------

    def observe(self, peer: str, t: float | None = None) -> None:
        """A successful heartbeat from ``peer`` (any evidence of life:
        a /healthz answer, a replication frame, a query response)."""
        now = time.monotonic() if t is None else t
        with self._lock:
            st = self._peers.get(peer)
            if st is None:
                return
            if not st.alive:
                # First beat of a comeback run starts the rejoin clock.
                if now - st.last_beat > self.dead_after_s:
                    st.beats_since = now
            st.last_beat = now

    # -- the guardrailed tick -------------------------------------------

    def tick(self, t: float | None = None) -> list[dict]:
        """Advance liveness; returns the reshard events APPLIED.

        Two-phase so the health double-check — a blocking HTTP probe
        that can take seconds against a dead host — NEVER runs under
        the membership lock: snapshot()/observe() callers (the daemon
        pump, /healthz handlers) must not stall behind a probe, or one
        dead shard would make healthy shards look silent to each other
        (the exact cascade the double-check exists to prevent)."""
        now = time.monotonic() if t is None else t
        # Phase 1 (lock): who crossed the dead edge this tick?
        with self._lock:
            suspects = [
                peer for peer, st in self._peers.items()
                if st.alive and now - st.last_beat > self.dead_after_s
            ]
        # Probe OUTSIDE the lock, and CONCURRENTLY across suspects
        # (bounded join): a sequential sweep of 6 s double-checks
        # would let one dead peer delay every other suspect's verdict
        # — per-peer degradation, never collective. A suspect whose
        # probe misses the bound simply gets no verdict this tick
        # (stays alive; the next tick retries). Flake guard (the
        # replication watchdog's primary-health pattern): a peer whose heartbeats
        # stalled but whose health surface still ANSWERS is
        # compile-stalled or suite-starved, not dead — credit the
        # watchdog, never reshard a serving shard's keyspace away.
        verdicts: dict[str, bool] = {}
        if self._health_check is not None and suspects:
            def check(peer: str) -> None:
                verdicts[peer] = self._safe_health(peer)

            checkers = [
                threading.Thread(
                    target=check, args=(peer,),
                    name=f"fleet-check-{peer}", daemon=True,
                )
                for peer in suspects
            ]
            for th in checkers:
                th.start()
            deadline = time.monotonic() + 8.0
            for th in checkers:
                th.join(max(deadline - time.monotonic(), 0.0))
        events: list[dict] = []
        with self._lock:
            self._bucket.advance(now)
            for peer, st in self._peers.items():
                silent = now - st.last_beat
                if st.alive and silent > self.dead_after_s:
                    if self._health_check is not None:
                        if verdicts.get(peer, False):
                            st.last_beat = now
                            continue
                        if peer not in verdicts:
                            # Crossed the edge between the phases:
                            # no verdict yet — next tick decides.
                            continue
                    st.alive = False
                    st.beats_since = float("inf")
                    if st.in_ring:
                        ev = self._apply_locked("leave", peer, now)
                        if ev is not None:
                            events.append(ev)
                elif not st.alive:
                    if silent > self.dead_after_s:
                        # Still silent: any rejoin run is broken.
                        st.beats_since = float("inf")
                        if st.in_ring:
                            # An earlier leave was REFUSED by the
                            # exhausted budget: retry once tokens
                            # refill — a permanently dead shard must
                            # not keep its keyspace forever (the
                            # refusal counter moved once; retries
                            # are silent until one lands).
                            ev = self._apply_locked("leave", peer, now)
                            if ev is not None:
                                events.append(ev)
                    elif (
                        now - st.beats_since >= self.rejoin_after_s
                        and not st.in_ring
                    ):
                        st.alive = True
                        ev = self._apply_locked("join", peer, now)
                        if ev is not None:
                            events.append(ev)
                    elif st.in_ring and silent <= self.dead_after_s:
                        # The ring froze while this peer was declared
                        # dead (refused leave) and it came back: it is
                        # simply alive again, no ring change needed.
                        st.alive = True
                elif not st.in_ring:
                    # Alive, beating, but OUT of the ring: its join
                    # was REFUSED by the exhausted budget (alive
                    # flipped before the refusal landed) — retry once
                    # tokens refill, symmetric with the refused-leave
                    # retry above: a healthy shard must not stay
                    # keyspace-less forever while /healthz calls it
                    # alive.
                    ev = self._apply_locked("join", peer, now)
                    if ev is not None:
                        events.append(ev)
        for ev in events:
            if self._on_reshard is not None:
                self._on_reshard(ev)
        return events

    def _safe_health(self, peer: str) -> bool:
        try:
            return bool(self._health_check(peer))
        except Exception:  # noqa: BLE001 — an unreachable health
            return False  # surface IS the dead signal

    def _apply_locked(self, op: str, peer: str, now: float) -> dict | None:
        if not self._bucket.take():
            if peer not in self._refused_pending:
                self.reshards_refused += 1
                self._refused_pending.add(peer)
            return None
        self._refused_pending.discard(peer)
        st = self._peers[peer]
        heir = None
        if op == "leave":
            if self.adoptive:
                heir = ring_heir(self.ring.members(), peer)
            if heir is not None:
                self.ring.adopt(peer, heir)
            else:
                self.ring.remove(peer)
            st.in_ring = False
        else:
            self.ring.add(peer)
            st.in_ring = True
        self.reshards_total += 1
        ev = {
            "op": op,
            "shard": peer,
            "t": now,
            "ring_version": self.ring.version(),
            "members": list(self.ring.members()),
        }
        if heir is not None:
            ev["heir"] = heir
        return ev

    # -- surfaces -------------------------------------------------------

    @property
    def frozen(self) -> bool:
        """True while the reshard budget is exhausted — the ring holds
        its last state and refuses changes (counted)."""
        return self._bucket.tokens < 1.0

    def live_count(self) -> int:
        with self._lock:
            return 1 + sum(1 for s in self._peers.values() if s.alive)

    def snapshot(self) -> dict:
        """The /healthz fleet block (and health_probe --shard body)."""
        with self._lock:
            peers = {
                p: {
                    "alive": st.alive,
                    "in_ring": st.in_ring,
                    "silence_s": round(
                        time.monotonic() - st.last_beat, 3
                    ),
                }
                for p, st in self._peers.items()
            }
        members = self.ring.members()
        return {
            "shard": self.self_id,
            "ring_version": self.ring.version(),
            "members": list(members),
            "adopted": self.ring.adopted(),
            "shards_live": self.live_count(),
            "shards_total": 1 + len(peers),
            "owned_vnodes": self.ring.vnodes,
            "peers": peers,
            "reshards_total": self.reshards_total,
            "reshards_refused": self.reshards_refused,
            "frozen": self.frozen,
        }


# -- the daemon-embedded member (heartbeat loop over HTTP health) -------


def http_health_alive(addr: str, timeout_s: float = 2.0) -> bool:
    """One /healthz poll against a peer's metrics address — the
    heartbeat AND the double-check probe (the double-check simply
    retries with a longer timeout). Any parseable answer counts:
    a saturated/degraded shard is ALIVE (shedding, not gone), and
    resharding its keyspace away would turn a brownout into data
    loss."""
    import http.client

    host, _, port = addr.rpartition(":")
    try:
        conn = http.client.HTTPConnection(
            host or "127.0.0.1", int(port), timeout=timeout_s
        )
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            resp.read()
            return resp.status in (200, 503)
        finally:
            conn.close()
    except Exception:  # noqa: BLE001 — any transport failure is "no beat"
        return False


class FleetMember:
    """The daemon's fleet leg: a supervised heartbeat loop polling
    every peer's /healthz, feeding :class:`FleetMembership`.

    ``peer_addrs``: shard-id → health address (host:metrics_port).
    The loop thread is daemonized and owned here (start/stop/alive —
    the supervision tree probes ``alive()``)."""

    def __init__(
        self,
        self_id: str,
        peer_addrs: dict[str, str],
        *,
        heartbeat_s: float = 1.0,
        vnodes: int = 128,
        dead_after_s: float = 3.0,
        rejoin_after_s: float = 5.0,
        reshard_budget: int = 4,
        reshard_refill_s: float = 60.0,
        on_reshard: Callable[[dict], None] | None = None,
        probe: Callable[[str], bool] | None = None,
        adoptive: bool = False,
    ):
        self._addrs = dict(peer_addrs)
        self._probe = probe or (
            lambda shard: http_health_alive(self._addrs[shard])
        )
        # The death double-check gets MORE patience than the routine
        # poll: a shard mid-compile (or starved by suite load) answers
        # slowly, not never — the slow answer must count as life.
        self._double_check = probe or (
            lambda shard: http_health_alive(
                self._addrs[shard], timeout_s=6.0
            )
        )
        self.membership = FleetMembership(
            self_id,
            self._addrs.keys(),
            vnodes=vnodes,
            dead_after_s=dead_after_s,
            rejoin_after_s=rejoin_after_s,
            reshard_budget=reshard_budget,
            reshard_refill_s=reshard_refill_s,
            health_check=lambda shard: self._safe_double_check(shard),
            on_reshard=on_reshard,
            adoptive=adoptive,
        )
        self.heartbeat_s = float(heartbeat_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _safe_probe(self, shard: str) -> bool:
        try:
            return bool(self._probe(shard))
        except Exception:  # noqa: BLE001 — unreachable = not alive
            return False

    def _safe_double_check(self, shard: str) -> bool:
        try:
            return bool(self._double_check(shard))
        except Exception:  # noqa: BLE001 — unreachable = not alive
            return False

    def _loop(self) -> None:
        # Peers are probed CONCURRENTLY and WITHOUT joining: each beat
        # lands its observe() from its own daemon thread, so the cycle
        # cadence is heartbeat_s regardless of how many peers are
        # blackholed — a 2 s probe timeout on one peer must never
        # stretch another peer's observation interval past the dead
        # edge (liveness degrades per peer, never collectively). A
        # per-shard in-flight guard bounds the threads: a peer slower
        # than the cadence has exactly ONE probe outstanding.
        inflight: set[str] = set()
        guard = threading.Lock()

        def beat(shard: str) -> None:
            try:
                if self._safe_probe(shard):
                    self.membership.observe(shard)
            finally:
                with guard:
                    inflight.discard(shard)

        while not self._stop.is_set():
            for shard in list(self._addrs):
                with guard:
                    if shard in inflight:
                        continue
                    inflight.add(shard)
                threading.Thread(
                    target=beat, args=(shard,),
                    name=f"fleet-beat-{shard}", daemon=True,
                ).start()
            self.membership.tick()
            self._stop.wait(self.heartbeat_s)

    def start(self) -> None:
        # A supervised restart calls stop() then start(): the stop
        # event must reset or the fresh thread exits immediately and
        # the supervisor restart-loops forever.
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-heartbeat", daemon=True
        )
        self._thread.start()

    def alive(self) -> bool:
        return self._thread is None or self._thread.is_alive()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def snapshot(self) -> dict:
        return self.membership.snapshot()


def parse_peer_list(
    raw: str, shards: int, self_index: int, prefix: str = "shard-"
) -> dict[str, str]:
    """ANOMALY_FLEET_PEERS / _QUERY_PEERS → {shard-<i>: addr}, the
    index-aligned contract (this shard's own slot, when present, is
    skipped — a member does not heartbeat itself)."""
    addrs = [a.strip() for a in str(raw).split(",") if a.strip()]
    out: dict[str, str] = {}
    for i, addr in enumerate(addrs):
        if i >= shards:
            break
        if i == self_index:
            continue
        out[f"{prefix}{i}"] = addr
    return out
