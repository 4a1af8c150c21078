"""Checkpoint and resume: detector snapshots keyed to stream offsets.

One ``<path>.ckpt`` file is one verified columnar frame
(``runtime.frame``): the state columns, and in the meta block the Kafka
offsets, the intern table, the config fingerprint, the window clock,
the fencing epoch and the keyspace generation, so state and offsets can
never be torn apart by a crash between two writes. The write goes
through a temp file, ``fsync`` and ``os.replace``. A truncated or
bit-rotted file fails the frame's checks, and :func:`load_resilient`
quarantines it and cold-starts.

The file is the reference's, byte for byte: a snapshot written by either
package loads in the other, so a detector's state moves between a TPU
deployment and a card. The config fingerprint leaves out
``sketch_impl``, an execution-backend knob. The pre-frame npz layout
("v0", at ``<path>.npz``) still restores through :func:`_load_arrays`;
the next save writes a frame and retires it.

``save`` on the card: the step advances the state in place on the
stream, so under the dispatch lock ``save`` only enqueues one
stream-ordered snapshot of the state (a device-side gather into one
buffer and one copy of it to pinned host memory) and reads the window
clock; it waits for the copy, encodes, checksums and fsyncs after
releasing the lock.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..models.detector import AnomalyDetector, DetectorConfig, DetectorState, state_from_numpy
from ..models.metrics_head import MetricsHeadConfig, MetricsHeadState, head_state_from_numpy
from . import frame
from .hostcopy import HostCopy

log = logging.getLogger(__name__)

# Current snapshot files are frames; ``.npz`` is the pre-frame ("v0")
# layout the loader still migrates from.
SUFFIX = ".ckpt"
LEGACY_SUFFIX = ".npz"

_NULL_LOCK = contextlib.nullcontext()


class CheckpointCorrupt(Exception):
    """A snapshot file that cannot be trusted: truncated, unreadable, or
    failing its checks. Distinct from a config mismatch (``ValueError``),
    which is an operator error and refuses boot; corruption degrades to a
    cold start."""


class StaleEpochError(RuntimeError):
    """A save carrying an old fencing epoch was refused: the snapshot on
    disk was written at a newer epoch, by a process that was promoted
    past this one."""


def _content_digest(state_np: dict, meta_json: str) -> str:
    """sha256 over the meta JSON and every array (name-sorted): the
    legacy npz layout's content check."""
    h = hashlib.sha256()
    h.update(meta_json.encode())
    for name in sorted(state_np):
        arr = np.ascontiguousarray(state_np[name])
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _feed_snapshot(feed) -> dict:
    """The metrics head's state (numpy) and intern tables, read under the
    feed's lock so no pump runs in between."""
    copy = HostCopy(feed.head.state)
    with feed._lock:
        copy.start(feed.head.state)
        snap = {
            "config": list(feed.head.config),
            "service_names": feed.service_names,
            "metric_names": feed.metric_names,
        }
    snap["state"] = MetricsHeadState(*copy.numpy())
    return snap


def save(
    path: str,
    detector: AnomalyDetector,
    offsets: dict[str, Any] | None = None,
    service_names: list[str] | None = None,
    metrics_feed=None,
    epoch: int = 0,
    generation: int = 0,
    *,
    dispatch_lock,
    stream=None,
) -> None:
    """Snapshot a live detector to disk.

    ``dispatch_lock`` is the owning pipeline's ``_dispatch_lock``. It is
    keyword-only with no default: a caller with a quiesced detector
    passes ``dispatch_lock=None`` deliberately. ``stream`` is the stream
    the steps run on (``DetectorPipeline.step_stream``); the copy is
    enqueued there, so it holds every step dispatched before it and no
    later one, whatever the calling thread's current stream is (None:
    the current stream). The lock is held only while the state's copy to
    the host is enqueued (and the clock read); the wait for it, the frame
    encode and the fsync'd write run outside.
    """
    copy = HostCopy(detector.state)
    with dispatch_lock if dispatch_lock is not None else _NULL_LOCK:
        copy.start(detector.state, stream=stream)
        clock_t_prev = detector.clock._t_prev
    save_state(
        path, DetectorState(*copy.numpy()), detector.config,
        offsets=offsets, service_names=service_names,
        clock_t_prev=clock_t_prev, metrics_feed=metrics_feed,
        epoch=epoch, generation=generation,
    )


def save_state(
    path: str,
    state: DetectorState,
    config: DetectorConfig,
    offsets: dict[str, Any] | None = None,
    service_names: list[str] | None = None,
    clock_t_prev: float | None = None,
    metrics_feed=None,
    epoch: int = 0,
    generation: int = 0,
) -> None:
    """Snapshot a global ``DetectorState`` (tensors or numpy arrays; a
    mesh run passes ``parallel.gather_state(state, mesh)``).

    Global shapes carry no device count, so the same snapshot restores
    onto one device (:func:`load`) or any mesh (:func:`load_onto_mesh`).
    Refuses with :class:`StaleEpochError` when the file on disk carries a
    newer epoch than ``epoch``.
    """
    existing_epoch = peek_epoch(path)
    if existing_epoch is not None and existing_epoch > epoch:
        raise StaleEpochError(
            f"snapshot at {path} carries epoch {existing_epoch} > writer epoch "
            f"{epoch}: refusing a stale-primary checkpoint save"
        )
    state_np = {k: _to_numpy(v) for k, v in state._asdict().items()}
    meta = {
        "offsets": offsets or {},
        "service_names": service_names or [],
        "config": list(config._replace(sketch_impl=None)),
        "clock_t_prev": clock_t_prev,
        "epoch": int(epoch),
        # Restore adopts it with the name table, whose EVICTED_SLOT
        # tombstones mark recycled-id holes.
        "generation": int(generation),
    }
    if metrics_feed is not None:
        snap = _feed_snapshot(metrics_feed)
        for name, arr in snap["state"]._asdict().items():
            state_np[f"metrics_{name}"] = arr
        meta["metrics_config"] = snap["config"]
        meta["metrics_service_names"] = snap["service_names"]
        meta["metrics_metric_names"] = snap["metric_names"]
    blob = frame.encode(state_np, meta=meta)
    tmp = path + ".tmp" + SUFFIX
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path + SUFFIX)
    # Retire older layouts after the new snapshot landed.
    for stale in (path + LEGACY_SUFFIX, path + ".json"):
        try:
            os.remove(stale)
        except OSError:
            pass


def _snapshot_file(path: str) -> str | None:
    """The snapshot file for ``path``: the frame layout wins; a legacy
    npz is the migration source. None = cold."""
    for suffix in (SUFFIX, LEGACY_SUFFIX):
        if os.path.exists(path + suffix):
            return path + suffix
    return None


def _load_arrays(path: str, config: DetectorConfig | None) -> tuple[dict, dict, DetectorConfig]:
    """Snapshot read + config validation → (arrays, meta, config).

    Anything the file can do wrong raises :class:`CheckpointCorrupt`;
    the semantic checks (frame version, config mismatch) raise
    ``ValueError``.
    """
    file = _snapshot_file(path)
    if file is None:
        raise FileNotFoundError(f"no snapshot at {path}")
    if file.endswith(SUFFIX):
        arrays, metrics_arrays, meta = _read_frame_snapshot(file)
    else:
        arrays, metrics_arrays, meta = _read_legacy_snapshot(file)
    meta["_metrics_arrays"] = metrics_arrays
    saved_cfg = DetectorConfig(*[tuple(v) if isinstance(v, list) else v for v in meta["config"]])
    # The caller keeps their own sketch_impl for this process.
    if config is not None:
        saved_cfg = saved_cfg._replace(sketch_impl=config.sketch_impl)
        if list(config) != list(saved_cfg):
            raise ValueError(f"checkpoint config {saved_cfg} does not match requested {config}")
    return arrays, meta, saved_cfg


def _split_metric_arrays(all_arrays: dict) -> tuple[dict, dict]:
    arrays = {
        k: v for k, v in all_arrays.items()
        if not k.startswith("metrics_") and k not in ("__meta__", "__digest__")
    }
    metrics_arrays = {
        k[len("metrics_"):]: v for k, v in all_arrays.items() if k.startswith("metrics_")
    }
    return arrays, metrics_arrays


def _read_frame_snapshot(file: str) -> tuple[dict, dict, dict]:
    """Current layout: the file is one verified columnar frame."""
    try:
        with open(file, "rb") as fh:
            blob = fh.read()
        fr = frame.decode(blob)
    except frame.FrameVersionError as e:
        # An upgrade-order problem, not corruption: refuse loudly.
        raise ValueError(f"{file}: {e}") from e
    except frame.FrameError as e:
        # File-content faults only; environment errors (permissions,
        # EIO) propagate, so a good snapshot is never moved aside.
        raise CheckpointCorrupt(f"{file} unreadable: {e}") from e
    arrays, metrics_arrays = _split_metric_arrays(fr.arrays)
    if "config" not in fr.meta:
        raise ValueError(
            f"{file} carries no config fingerprint; it was written by an incompatible version"
        )
    return arrays, metrics_arrays, dict(fr.meta)


def _read_legacy_snapshot(file: str) -> tuple[dict, dict, dict]:
    """The pre-frame npz layout ("v0"), verified by its embedded sha256
    digest when present."""
    try:
        raw = frame.read_npz(file)
    except frame.FrameCorrupt as e:
        raise CheckpointCorrupt(f"{file} unreadable: {e}") from e
    if "__meta__" not in raw:
        raise ValueError(
            f"{file} is not a self-contained checkpoint (missing __meta__); "
            "it was written by an incompatible version"
        )
    try:
        meta_json = str(raw["__meta__"][()])
        meta = json.loads(meta_json)
    except ValueError as e:
        raise CheckpointCorrupt(f"{file} meta unreadable: {e}") from e
    stored_digest = str(raw["__digest__"][()]) if "__digest__" in raw else None
    arrays, metrics_arrays = _split_metric_arrays(raw)
    if stored_digest is not None:
        all_arrays = dict(arrays)
        all_arrays.update({f"metrics_{k}": v for k, v in metrics_arrays.items()})
        actual = _content_digest(all_arrays, meta_json)
        if actual != stored_digest:
            raise CheckpointCorrupt(
                f"{file} content digest mismatch "
                f"(stored {stored_digest[:12]}…, computed {actual[:12]}…)"
            )
    return arrays, metrics_arrays, meta


def load(
    path: str,
    config: DetectorConfig | None = None,
    device: "torch.device | str | None" = None,
) -> tuple[AnomalyDetector, dict]:
    """Restore a detector (state and window clock) on ``device`` (the
    card unless the caller names another) and return (detector, meta).
    The snapshot may come from any topology or either package."""
    device = resolve_device(device)
    arrays, meta, saved_cfg = _load_arrays(path, config)
    detector = AnomalyDetector(saved_cfg, device=device)
    detector.state = state_from_numpy(DetectorState(**arrays), device)
    detector.clock._t_prev = meta.get("clock_t_prev")
    return detector, meta


def load_resilient(
    path: str,
    config: DetectorConfig | None = None,
    device: "torch.device | str | None" = None,
) -> tuple[AnomalyDetector | None, dict | None, bool]:
    """Boot-path load: ``(detector, meta, corrupt)``.

    A truncated or bit-rotted snapshot degrades to a cold start
    (``(None, None, True)``) and the file is quarantined to
    ``<file>.corrupt``; a config mismatch still raises; a missing file is
    ``(None, None, False)``.
    """
    device = resolve_device(device)
    file = _snapshot_file(path)
    if file is None:
        return None, None, False
    try:
        detector, meta = load(path, config, device)
        return detector, meta, False
    except CheckpointCorrupt as e:
        log.error("checkpoint corrupt, falling back to cold start: %s", e)
        try:
            os.replace(file, file + ".corrupt")
        except OSError:
            pass
        return None, None, True


def load_onto_mesh(path: str, config: DetectorConfig | None, mesh) -> tuple[DetectorState, dict]:
    """Elastic restore: this rank's slice of a snapshot, on
    ``mesh.device`` (``parallel.place_state``). Pair with
    ``parallel.make_sharded_step(config, mesh)`` and use the returned
    state in place of its fresh one; seed the window clock with
    ``meta["clock_t_prev"]``."""
    from ..parallel.spmd import place_state

    arrays, meta, _saved_cfg = _load_arrays(path, config)
    meta.setdefault("clock_t_prev", None)
    return place_state(DetectorState(**arrays), mesh), meta


def exists(path: str) -> bool:
    return _snapshot_file(path) is not None


def peek_epoch(path: str) -> int | None:
    """Fencing epoch of the snapshot at ``path``, or None (no file, an
    unreadable one). A frame answers from its header and meta alone,
    never the payload; with both layouts present the largest epoch
    wins."""
    best: int | None = None
    for suffix in (SUFFIX, LEGACY_SUFFIX):
        file = path + suffix
        if not os.path.exists(file):
            continue
        try:
            if suffix == SUFFIX:
                meta = frame.peek_file_meta(file).meta
            else:
                raw = frame.read_npz(file)
                if "__meta__" not in raw:
                    continue
                meta = json.loads(str(raw["__meta__"][()]))
        except Exception:  # noqa: BLE001 — fencing needs readable evidence only
            continue
        epoch = int(meta.get("epoch", 0))
        best = epoch if best is None else max(best, epoch)
    return best


def restore_metrics_feed(meta: dict, feed) -> bool:
    """Hydrate a ``MetricsFeed`` from :func:`load`'s meta. False (feed
    untouched) when the snapshot has no metrics leg or its geometry does
    not match the feed's."""
    arrays = meta.get("_metrics_arrays") or {}
    if not arrays or meta.get("metrics_config") is None:
        if arrays or meta.get("metrics_config") is not None:
            log.warning(
                "metrics-feed restore skipped: snapshot carries %s but not %s — "
                "metrics head cold-starts",
                "arrays" if arrays else "metrics_config",
                "metrics_config" if arrays else "arrays",
            )
        return False
    saved_cfg = MetricsHeadConfig(
        *[tuple(v) if isinstance(v, list) else v for v in meta["metrics_config"]]
    )
    if list(saved_cfg) != list(feed.config):
        mismatched = [
            name
            for name, saved, cur in zip(MetricsHeadConfig._fields, saved_cfg, feed.config)
            if (tuple(saved) if isinstance(saved, (list, tuple)) else saved)
            != (tuple(cur) if isinstance(cur, (list, tuple)) else cur)
        ]
        log.warning(
            "metrics-feed restore skipped: config mismatch on %s (snapshot %s vs running %s) "
            "— metrics head cold-starts, span-leg state restored normally",
            ", ".join(mismatched) or "<unknown field>", saved_cfg, feed.config,
        )
        return False
    with feed._lock:
        feed.head.state = head_state_from_numpy(MetricsHeadState(**arrays), feed.head.device)
        for name in meta.get("metrics_service_names", []):
            feed._intern_service(name)
        for name in meta.get("metrics_metric_names", []):
            feed.metric_id(name)
    return True
