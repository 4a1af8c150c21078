"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes one plain C launcher (``<name>_launch``)
that launches on the caller's stream and returns the launch's error code.
This module compiles a source with ``nvcc`` for ``sm_90a`` at its first
use, into ``build/torch_kernels/`` beside the package (the file name
carries a hash of the source and the shared ``csrc/*.cuh`` headers, so an
edited kernel is rebuilt), loads it with ``ctypes``, and raises if a
build or a launch fails. There is no
fallback: a caller with a CUDA tensor gets the kernel or an exception.

Each launcher here adds one to ``LAUNCHES[name]`` when it launches its
kernel, and nowhere else, so a run can show that its path went through
the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

# Extra nvcc flags per kernel. The stats partials and the head epilogue of
# the sketch kernels are built without FMA contraction so they round once
# per operation, as the plain PyTorch versions do.
_FLAGS = {
    "fused_update": ["--fmad=false"],
    "cms_hist": [],
    "sketch_delta": ["--fmad=false"],
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    "fused_update": [
        _P, _P, _P, _P, _P, _P, _P,  # svc log_lat is_error hi lo cidx valid
        _I, _I, _I, _I, _I,  # B S p D Wc
        _P, _L, _P, _L, _I,  # hll hll_ws cms cms_ws n_windows
        _P, _P,  # partials stats
        _I, _I, _I, _I,  # grid threads lanes_per_block smem
        _I,  # fold
        _P, _P, _P, _P, _P, _P, _P,  # lat_mean lat_var err_mean rate_mean rate_var cusum obs
        _P, _P,  # dt step_idx
        _P, _P, _P,  # lat_z err_z rate_z
        ctypes.POINTER(_F), _I,  # taus n_taus
        _F, _F, _F, _F, _F,  # warmup z_warmup cusum_k cusum_cap err_slack
        _P,  # stream
    ],
    "cms_hist": [
        _P, _P, _L, _I, _I,  # idx valid B D W
        _P,  # out
        _I, _I, _I,  # grid threads lanes_per_block
        _P,  # stream
    ],
    "sketch_delta": [
        _P, _P, _P, _P, _P, _P, _P,  # svc log_lat is_error hi lo cidx valid
        _I, _I, _I, _I, _I,  # B S p D Wc
        _P, _P, _P,  # out partials stats
        _I, _I, _I, _I,  # stat_blocks threads lanes_per_block smem
        _I,  # grid
        _P,  # stream
    ],
}

# Largest dynamic shared memory an H100 block may opt in to, in bytes,
# and the streaming multiprocessors of an H100 SXM (launch plans read the
# card's own count through sm_count).
SMEM_LIMIT = 232448
N_SMS = 132

LAUNCHES = {name: 0 for name in _ARGTYPES}
BUILD_LOG: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = b"".join(
        p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    )
    key = hashlib.sha256(src + " ".join(_FLAGS[name]).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{key}.so"


def _compile_cmd(name: str, out: Path) -> list[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xptxas", "-v", *_FLAGS[name], "-shared", "-Xcompiler",
        "-fPIC", "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns ``name → library path``;
    raises with the compiler's output if any build fails. The compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept in
    ``BUILD_LOG``."""
    names = list(_ARGTYPES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    paths = {}
    for name in names:
        out = _lib_path(name)
        paths[name] = out
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _compile_cmd(name, tmp),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    return paths


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class HistPlan(NamedTuple):
    """How the ``cms_hist`` kernel is launched for one call."""

    grid: int  # blocks, at most one per SM
    threads: int  # threads per block
    lanes_per_block: int  # each block's run of lanes; blocks past the lanes only clear


# Threads per block of the histogram kernel (its __launch_bounds__), and
# the output ints a block clears in one pass (an int4 a thread).
HIST_THREADS = 512
_HIST_CLEAR_PER_BLOCK = 4 * HIST_THREADS


def hist_plan(n_lanes: int, n_out: int, n_sms: int = N_SMS) -> HistPlan:
    """The ``cms_hist`` launch for ``n_lanes`` lanes and ``n_out`` output
    counts on a card of ``n_sms`` SMs: each block a run of whole 32-lane
    slices, about ``n_lanes / n_sms`` lanes, and as many blocks as the
    lanes or the clear (2,048 ints a block a pass) need, at most one per
    SM (the launch is cooperative). The bin count sets no limit: a block
    keeps no histogram of its own, so ``n_out`` only sizes the clear."""
    per_sm = -(-n_lanes // n_sms)
    lanes = max(32, -(-per_sm // 32) * 32)
    need = max(-(-n_lanes // lanes), -(-n_out // _HIST_CLEAR_PER_BLOCK), 1)
    return HistPlan(min(n_sms, need), HIST_THREADS, lanes)


def launch_cms_hist(
    idx: torch.Tensor, valid: torch.Tensor | None, width: int, out: torch.Tensor
) -> None:
    """Launch the histogram kernel on the current stream: it clears
    ``out[D, width]`` and counts ``idx[D, B]`` (int32, contiguous, CUDA)
    into it, lanes whose ``valid`` is False (when given) and keys outside
    ``[0, width)`` skipped. Tensors are validated by the caller
    (ops.cms)."""
    d, b = idx.shape
    plan = hist_plan(b, d * width, sm_count(idx.device.index))
    fn = _lib("cms_hist").cms_hist_launch
    rc = fn(
        _ptr(idx), _ptr(valid), b, d, width, _ptr(out), *plan, _stream(idx.device),
    )
    _check("cms_hist", rc)
    LAUNCHES["cms_hist"] += 1


@functools.cache
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_fused_update(
    *, svc, log_lat, is_error, trace_hi, trace_lo, cidx, valid,
    num_services, hll_p, cms_width, hll_cur, cms_cur, partials, stats, plan,
    heads=None, dt=None, step_idx=None, zs=None, statics=None,
) -> None:
    """Launch the sketch kernel (banks, stats and, with ``heads``, the
    head epilogue) on the current stream, per ``plan`` (a
    ``fused.SketchPlan``). Tensors are validated by the caller
    (ops.fused)."""
    b = svc.shape[0]
    d = cidx.shape[0]
    n_windows = hll_cur.shape[0]
    fold = heads is not None
    if fold:
        taus = statics["taus_s"]
        taus_arr = (_F * len(taus))(*taus)
        head_ptrs = [_ptr(h) for h in heads]
        extra = [
            _ptr(dt), _ptr(step_idx), *(_ptr(z) for z in zs), taus_arr,
            len(taus), statics["warmup_batches"], statics["z_warmup_batches"],
            statics["cusum_k"], statics["cusum_cap"], statics["err_slack"],
        ]
    else:
        head_ptrs = [None] * 7
        extra = [None, None, None, None, None, (_F * 1)(0.0), 0, 0.0, 0.0, 0.0, 0.0, 0.0]
    fn = _lib("fused_update").fused_update_launch
    rc = fn(
        _ptr(svc), _ptr(log_lat), _ptr(is_error), _ptr(trace_hi),
        _ptr(trace_lo), _ptr(cidx), _ptr(valid),
        b, num_services, hll_p, d, cms_width,
        _ptr(hll_cur), hll_cur.stride(0), _ptr(cms_cur), cms_cur.stride(0),
        n_windows, _ptr(partials), _ptr(stats), *plan, int(fold),
        *head_ptrs, *extra, _stream(svc.device),
    )
    _check("fused_update", rc)
    LAUNCHES["fused_update"] += 1


def launch_sketch_delta(
    *, svc, log_lat, is_error, trace_hi, trace_lo, cidx, valid,
    num_services, hll_p, cms_width, out, partials, stats, plan,
) -> None:
    """Launch the delta's sketch kernel on the current stream, per
    ``plan`` (a ``fused.SketchPlan``): it clears ``out`` (the HLL
    registers then the CMS counters, one int32 buffer) and fills it. The
    plan's blocks own the lanes; the launch adds blocks up to one per SM
    that only share the clear. Tensors are validated by the caller
    (ops.fused)."""
    fn = _lib("sketch_delta").sketch_delta_launch
    rc = fn(
        _ptr(svc), _ptr(log_lat), _ptr(is_error), _ptr(trace_hi),
        _ptr(trace_lo), _ptr(cidx), _ptr(valid),
        svc.shape[0], num_services, hll_p, cidx.shape[0], cms_width,
        _ptr(out), _ptr(partials), _ptr(stats), *plan,
        max(plan.grid, sm_count(svc.device.index)), _stream(svc.device),
    )
    _check("sketch_delta", rc)
    LAUNCHES["sketch_delta"] += 1
