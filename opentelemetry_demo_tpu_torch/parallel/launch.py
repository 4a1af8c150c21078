"""Run a function on every rank of a local ``torch.distributed`` world.

:func:`run_world` starts one process per rank with the ``spawn`` context
(CUDA forbids ``fork`` once it is initialised), rendezvouses them on a
free local port, runs ``body(*args)`` on each rank and returns each rank's
result. It joins with a hard deadline: on a timeout, a failed rank or a
rank that dies, it kills every child and raises with the children's
tracebacks and the tail of their stderr.

The rank bodies that drive the sharded detector step live here too
(:func:`replay_sharded`, :func:`ring_allreduce`, :func:`run_tasks`): a
spawned child imports the module of its target, so a body must live in a
module that imports nothing but this package.

    from opentelemetry_demo_tpu_torch.parallel import launch
    out = launch.run_world(launch.replay_sharded, 4, "cuda", "gloo", 300.0,
                           (2, 2), "cuda", [launch.Scenario(...)])
"""

from __future__ import annotations

import multiprocessing as mp
from multiprocessing import connection
import os
import socket
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Iterable, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.detector import DetectorConfig, DetectorReport, state_to_numpy
from ..models.windows import WindowClock
from ..ops import _kernels
from ..runtime import checkpoint
from ..runtime.tensorize import SpanTensorizer
from .mesh import host_staged, make_hybrid_mesh, make_mesh, rank_device
from .ring import merge_states_across
from .spmd import gather_report, gather_state, make_sharded_step, shard_batch

_STDERR_TAIL = 4000  # bytes of each child's stderr quoted in an error


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank, world, port, device_type, backend, timeout_s, body, args, conn, err_path):
    fd = os.open(err_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 2)
    os.close(fd)
    torch.set_num_threads(1)
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=timedelta(seconds=timeout_s),
        )
        try:
            result = body(*args)
        finally:
            dist.destroy_process_group()
        conn.send(("ok", result))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise SystemExit(1)
    finally:
        conn.close()


def _tail(path: str) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - _STDERR_TAIL))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def run_world(
    body: Callable,
    world: int,
    device_type: str = "cuda",
    backend: str | None = None,
    timeout_s: float = 120.0,
    *args,
) -> list:
    """``[body(*args) on rank r for r in range(world)]``, each rank in its
    own spawned process, the world initialised over ``backend`` (default
    NCCL for ``"cuda"``, gloo for ``"cpu"``). Ranks on ``"cuda"`` take
    card ``rank % device_count``. ``timeout_s`` bounds the whole run and
    each collective; past it every child is killed and this raises."""
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    ctx = mp.get_context("spawn")
    port = _free_port()
    deadline = time.monotonic() + timeout_s
    procs, conns = [], []
    with tempfile.TemporaryDirectory(prefix="world-") as tmp:
        errs = [os.path.join(tmp, f"rank{r}.err") for r in range(world)]
        try:
            for r in range(world):
                recv, send = ctx.Pipe(duplex=False)
                p = ctx.Process(
                    target=_child, daemon=True,
                    args=(r, world, port, device_type, backend, timeout_s, body,
                          args, send, errs[r]),
                )
                p.start()
                send.close()
                procs.append(p)
                conns.append(recv)
            results: list = [None] * world
            pending = dict(enumerate(conns))
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(pending)} gave no result in {timeout_s} s")
                for c in connection.wait(list(pending.values()), timeout=left):
                    r = conns.index(c)
                    try:
                        status, payload = c.recv()
                    except EOFError:
                        procs[r].join(5)
                        status = "error"
                        payload = f"rank {r} exited (code {procs[r].exitcode}) without a result"
                    del pending[r]
                    if status != "ok":
                        raise RuntimeError(f"rank {r} failed:\n{payload}")
                    results[r] = payload
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
                if p.is_alive():
                    raise TimeoutError(f"a rank did not exit within {timeout_s} s")
            return results
        except BaseException as exc:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(5)
            if not isinstance(exc, Exception):
                raise
            stderr = "\n".join(
                f"--- rank {r} stderr (tail) ---\n{_tail(e)}" for r, e in enumerate(errs)
            )
            raise RuntimeError(
                f"world of {world} ({device_type}, {backend}) failed: {exc}\n{stderr}"
            ) from exc
        finally:
            for c in conns:
                c.close()


# -- rank bodies ---------------------------------------------------------------


@dataclass(frozen=True)
class SyntheticStream:
    """A reproducible stream of global span batches, made from ``seed``:
    ``n_active`` services with their own latency scales, a 1% error rate,
    Zipf-distributed attributes, ``width // 32`` padding lanes per batch,
    and from step ``fault_from`` on (when ``>= 0``) a ``fault_scale``×
    latency step on ``fault_service``. Iterating yields ``TensorBatch``es,
    from step ``start`` on (the steps before it are drawn and dropped, so
    a stream resumed at ``start`` continues the same batches)."""

    seed: int
    n_steps: int
    width: int
    num_services: int
    n_active: int = 20
    fault_service: int = 0
    fault_from: int = -1
    fault_scale: float = 10.0
    start: int = 0

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        tz = SpanTensorizer(self.num_services, self.width)
        n = self.width - self.width // 32
        for k in range(self.n_steps):
            svc = rng.integers(0, self.n_active, n).astype(np.int32)
            lat = rng.gamma(8.0, 300.0 * (1.0 + svc) / 8.0)
            if 0 <= self.fault_from <= k:
                lat = np.where(svc == self.fault_service, lat * self.fault_scale, lat)
            batch = tz.pack_arrays(
                svc,
                lat.astype(np.float32),
                rng.integers(0, 2**63, n, dtype=np.uint64),
                (rng.random(n) < 0.01).astype(np.float32),
                (rng.zipf(1.3, n) % 500).astype(np.uint64),
            )
            if k >= self.start:
                yield batch


def window_rotations(windows_s: Sequence[float], n_steps: int, dt: float) -> list[np.ndarray]:
    """The rotate masks a :class:`WindowClock` gives at ``t = k · dt``."""
    clock = WindowClock(tuple(windows_s))
    return [clock.tick(k * dt)[1] for k in range(n_steps)]


class Scenario(NamedTuple):
    """One replay: global batches (lane tuples such as ``TensorBatch``, or
    a :class:`SyntheticStream`) with a rotate mask per step, a fixed
    ``dt`` and the merge to use. With ``snapshot`` (a checkpoint path)
    the replay resumes from it (``checkpoint.load_onto_mesh``) instead of
    a fresh state."""

    config: DetectorConfig
    batches: Iterable
    rotates: Sequence
    dt: float = 0.25
    comm_impl: str = "direct"
    snapshot: str | None = None


def _report_to_numpy(report: DetectorReport) -> DetectorReport:
    return DetectorReport(*(t.detach().cpu().numpy() for t in report))


def replay_sharded(layout: tuple, device_type: str, scenarios: Sequence[Scenario]) -> list[dict]:
    """Rank body: build the mesh (``(n_batch, n_sketch)`` or ``(n_dcn,
    n_batch, n_sketch)``), then replay each scenario through a fresh
    sharded step. Per scenario it returns the mesh ``shape``, this rank's
    ``coords``, its local state and reports (numpy), the gathered global
    state and reports, the kernel launches counted during the replay
    alone, and the replay's wall seconds (host clock, batches already
    packed)."""
    if len(layout) == 2:
        mesh = make_mesh(*layout, device_type=device_type)
    else:
        mesh = make_hybrid_mesh(*layout, device_type=device_type)
    out = []
    for sc in scenarios:
        batches = list(sc.batches)
        step, state = make_sharded_step(sc.config, mesh, sc.comm_impl)
        if sc.snapshot is not None:
            state, _meta = checkpoint.load_onto_mesh(sc.snapshot, sc.config, mesh)
        dt = torch.tensor(sc.dt, dtype=torch.float32, device=mesh.device)
        reports = []
        _kernels.reset_launches()
        t0 = time.perf_counter()
        for batch, rotate in zip(batches, sc.rotates):
            rot = torch.from_numpy(np.asarray(rotate, dtype=bool)).to(mesh.device)
            state, report = step(state, *shard_batch(batch, mesh), dt, rot)
            reports.append(report)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        wall = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        out.append(dict(
            shape=dict(mesh.shape),
            coords=dict(mesh.coords),
            launches=launches,
            wall_s=wall,
            local_state=state_to_numpy(state),
            local_reports=[_report_to_numpy(r) for r in reports],
            state=gather_state(state, mesh),
            reports=[gather_report(r, mesh) for r in reports],
        ))
    return out


def ring_allreduce(xs: np.ndarray, sizes: Sequence[int], device_type: str) -> dict:
    """Rank body: for each ``n`` in ``sizes``, ranks ``0 .. n-1`` merge
    their row ``xs[rank]`` (as both the HLL and the CMS bank) across the
    ring and directly. Returns ``{n: (ring max, ring sum, direct max,
    direct sum)}`` on the ranks of each group."""
    rank = dist.get_rank()
    device = rank_device(device_type)
    out = {}
    for n in sizes:
        group = dist.new_group(list(range(n)))
        if rank < n:
            x = torch.from_numpy(xs[rank]).to(device)
            ring = merge_states_across(group, x, x, use_ring=True, host_staged=host_staged(device))
            direct = merge_states_across(group, x.clone(), x.clone(), use_ring=False)
            out[n] = tuple(t.cpu().numpy() for t in (*ring, *direct))
    return out


def run_tasks(tasks: Sequence[tuple[Callable, tuple]]) -> list:
    """Rank body: run several bodies in one world, in order."""
    return [fn(*args) for fn, args in tasks]
