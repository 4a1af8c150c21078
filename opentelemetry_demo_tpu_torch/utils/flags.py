"""flagd-style feature flags: file-backed evaluation and an OFREP client.

The shop's whole fault-injection surface is a flagd JSON file,
evaluated by the OpenFeature SDK in every service and edited live
through the flag editor. This module is the same control plane:

- :class:`FlagFileStore` watches a flagd-schema JSON file and reloads it
  when its mtime changes (flagd's own file-backed mode);
- :class:`FlagEvaluator` evaluates ``state``/``variants``/
  ``defaultVariant`` and the ``fractional`` targeting rule (a weighted
  bucket on a targeting key, e.g. a session id), the subset the shop's
  flags use;
- :class:`OfrepClient` evaluates over OpenFeature REST (OFREP) against a
  live flagd, for deployments where the detector shares the shop's flagd
  instead of a local file.

The detector reads its own switches through this layer:
``anomalyDetectorEnabled`` and ``anomalyDetectorZThreshold``
(``runtime.pipeline``). The answers are the JAX package's ``flags``'s,
bucket for bucket.
"""

from __future__ import annotations

import json
import os
import random
import tempfile
import time
import urllib.error
import urllib.request
import zlib
from typing import Any


def capped_jitter_backoff(attempt: int, base_s: float, cap_s: float) -> float:
    """Capped exponential backoff with full jitter, as one shared
    formula: ``min(base * 2^attempt, cap) * uniform[0.5, 1.5)``. The
    OFREP client's transient retries use it, so the flag plane's retry
    shape cannot drift between its transports."""
    base = min(base_s * (2.0 ** attempt), cap_s)
    return base * (0.5 + random.random())


def atomic_write_doc(path: str, doc: dict) -> None:
    """THE flag-file write primitive: tmp file + ``os.replace``.

    Services hot-reload the flagd file on mtime and must never observe
    a torn write (``FlagFileStore`` *tolerates* one — it keeps serving
    the previous snapshot — but no writer may produce one in the first
    place). Every flag-store writer goes through here, the flag editor
    (``flag_ui.py``) first among them."""
    dir_ = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=dir_, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class FlagEvaluator:
    """Evaluate flags from a flagd-schema dict ``{"flags": {...}}``."""

    def __init__(self, doc: dict | None = None):
        self._doc = doc or {"flags": {}}
        # Bumped on every replace(): the change signal flagd's
        # EventStream pushes as configuration_change events.
        self.version = 0

    def replace(self, doc: dict) -> None:
        self._doc = doc or {"flags": {}}
        self.version += 1

    def _refresh(self) -> None:
        """Pre-read hook; file-backed subclasses hot-reload here so
        EVERY public read path (resolve/evaluate/keys/specs/snapshot)
        sees the current document, not just evaluate()."""

    def poll_version(self) -> int:
        """Refresh, then return the document version — THE way to watch
        for changes (flagd EventStream et al). Reading the bare
        ``version`` attribute skips the file-store reload hook and
        misses file-only writes."""
        self._refresh()
        return self.version

    def snapshot(self) -> dict:
        """Deep copy of the live flagd document — THE public read /
        copy-for-write surface (callers mutate the copy and
        :meth:`replace` it back; nobody reaches into ``_doc``).
        JSON round-trip: the document is JSON by contract (flagd file
        schema), and this also catches non-JSON values early."""
        self._refresh()
        return json.loads(json.dumps(self._doc))

    def flag_keys(self) -> list[str]:
        self._refresh()
        return list(self._doc.get("flags", {}))

    def flag_spec(self, key: str) -> dict | None:
        """READ-ONLY view of one flag's live spec (no copy) — callers
        must not mutate; use :meth:`snapshot` + :meth:`replace` to
        write. Safe concurrently: ``replace`` swaps the whole document
        reference atomically."""
        self._refresh()
        spec = self._doc.get("flags", {}).get(key)
        return spec if isinstance(spec, dict) else None

    def flag_specs(self) -> dict:
        """READ-ONLY view of the live flags mapping (same contract as
        :meth:`flag_spec`)."""
        self._refresh()
        return self._doc.get("flags", {})

    def evaluate(self, key: str, default: Any, targeting_key: str = "") -> Any:
        """Return the flag's value, or ``default`` if absent/disabled."""
        try:
            value, _variant, _reason = self.resolve(key, targeting_key)
        except KeyError:
            return default
        return value

    def resolve(self, key: str, targeting_key: str = "") -> tuple:
        """Full resolution: ``(value, variant_name, reason)``.

        The flagd evaluation contract (schemas.flagd.dev): raises
        ``KeyError`` for a flag that is absent, DISABLED, or whose
        selected variant does not exist — the cases flagd answers with
        FLAG_NOT_FOUND. Reason is ``TARGETING_MATCH`` when a fractional
        rule picked the variant, ``STATIC`` otherwise.
        """
        self._refresh()
        flag = self._doc.get("flags", {}).get(key)
        if not isinstance(flag, dict):
            raise KeyError(key)
        if str(flag.get("state", "ENABLED")).upper() == "DISABLED":
            raise KeyError(key)
        variants = flag.get("variants", {})
        variant = flag.get("defaultVariant")
        reason = "STATIC"
        targeting = flag.get("targeting") or {}
        frac = targeting.get("fractional")
        if isinstance(frac, list) and frac:
            variant = self._fractional(key, frac, targeting_key, variant)
            reason = "TARGETING_MATCH"
        if variant not in variants:
            raise KeyError(key)
        return variants[variant], str(variant), reason

    @staticmethod
    def _fractional(
        key: str, rule: list, targeting_key: str, fallback: Any
    ) -> Any:
        """Weighted variant pick, sticky per targeting key.

        flagd buckets ``hash(flagKey + targetingKey)`` over the weight
        sum; we use crc32 for the same stable-bucket property (the exact
        hash need not match flagd's murmur3 — stickiness and weighting
        are the contract that matters to the demo's percentage flags).
        """
        pairs = []
        for entry in rule:
            if isinstance(entry, list) and len(entry) == 2:
                pairs.append((str(entry[0]), float(entry[1])))
        total = sum(w for _, w in pairs)
        if total <= 0:
            return fallback
        bucket = zlib.crc32(f"{key}{targeting_key}".encode()) % int(total)
        acc = 0.0
        for name, weight in pairs:
            acc += weight
            if bucket < acc:
                return name
        return fallback


class FlagFileStore(FlagEvaluator):
    """File-backed evaluator with mtime-based hot reload."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._mtime = -1.0
        self._maybe_reload(force=True)

    def _maybe_reload(self, force: bool = False) -> None:
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            return
        if force or mtime != self._mtime:
            try:
                with open(self.path) as f:
                    self.replace(json.load(f))
                self._mtime = mtime
            except (OSError, json.JSONDecodeError):
                # Keep serving the previous snapshot on a torn write —
                # flagd-ui rewrites the file in place.
                pass

    def _refresh(self) -> None:
        # The base class calls this before EVERY public read
        # (resolve/evaluate/keys/specs/snapshot), so a file edit is
        # visible on the next read of any kind, not just evaluate().
        self._maybe_reload()


class OfrepClient:
    """Minimal OFREP client (stdlib-only; gated by reachability).

    ``evaluate`` degrades to the default on any transport error so the
    detector never hard-depends on the flag service being up — matching
    the OpenFeature SDK's error-default semantics.

    Transport hardening (a sick flagd must cost a caller a bounded,
    known amount): every request carries a bounded
    connect/read timeout, and TRANSIENT failures (connection refused /
    reset / timeout / 5xx / 429) are retried up to ``retries`` times
    with capped exponential backoff and full jitter. Definitive
    answers (404 — flag
    genuinely absent — and other 4xx) return the default immediately:
    retrying a NOT_FOUND would only triple the latency of a correct
    answer.

    Circuit half: a pipeline pump evaluates the detector's gating
    flag through this client ONCE PER BATCH, so a sustained outage
    must not pay the retry burst on every call. After an evaluate
    fails all its attempts the client enters a ``failure_cooldown_s``
    window in which each evaluate makes a SINGLE bounded attempt (the
    pre-hardening per-call cost); the first success closes the
    window. Worst case per call is therefore one timeout during an
    outage, and ``retries`` × timeout + capped backoff only at the
    outage's first detection — never an unbounded hang.
    """

    BACKOFF_BASE_S = 0.05
    BACKOFF_CAP_S = 0.5

    def __init__(self, base_url: str, timeout_s: float = 1.0,
                 retries: int = 2, failure_cooldown_s: float = 5.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.retries = max(int(retries), 0)
        self.failure_cooldown_s = float(failure_cooldown_s)
        self.transient_failures = 0  # retried transport faults, lifetime
        self._down_until = 0.0  # monotonic: single-attempt mode window

    def _backoff_s(self, attempt: int) -> float:
        return capped_jitter_backoff(
            attempt, self.BACKOFF_BASE_S, self.BACKOFF_CAP_S
        )

    def evaluate(self, key: str, default: Any, targeting_key: str = "") -> Any:
        url = f"{self.base_url}/ofrep/v1/evaluate/flags/{key}"
        body = json.dumps({"context": {"targetingKey": targeting_key}}).encode()
        attempts = (
            1 if time.monotonic() < self._down_until
            else self.retries + 1
        )
        for attempt in range(attempts):
            req = urllib.request.Request(
                url, data=body,
                headers={"Content-Type": "application/json"},
            )
            try:
                with urllib.request.urlopen(
                    req, timeout=self.timeout_s
                ) as resp:
                    payload = json.load(resp)
                self._down_until = 0.0  # circuit closes on success
                return payload.get("value", default)
            except urllib.error.HTTPError as e:
                if e.code < 500 and e.code != 429:
                    # Definitive refusal (404 flag-not-found et al):
                    # the default IS the answer, retrying buys nothing.
                    self._down_until = 0.0
                    return default
                self.transient_failures += 1
            except Exception:  # noqa: BLE001 — transport fault
                # (refused/reset/timeout/DNS): the OpenFeature
                # error-default contract — degrade, never raise into
                # the evaluating service.
                self.transient_failures += 1
            if attempt + 1 < attempts:
                time.sleep(self._backoff_s(attempt))
        self._down_until = time.monotonic() + self.failure_cooldown_s
        return default
