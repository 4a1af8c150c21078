"""Count-Min sketch on count tensors ``int32[..., D, W]``.

The table is global, with the service folded into the key hash. Row
hashes use the Kirsch–Mitzenmacher construction ``g_i = lo + i·hi``
(mod 2³²) from one 64-bit key hash. Update is a scatter-add, merge an
elementwise add, query a min over the D rows.

:func:`cms_count` is the CMS count of the composed sketch path, and
:func:`cms_hist` the flat histogram the reference's MXU engine computes.
On a CUDA tensor both launch the hand-written histogram kernel
(``csrc/cms_hist.cu``, one launch that clears its own output); on a CPU
tensor they run :func:`cms_count_plain` and :func:`cms_hist_plain`, the
sort/searchsorted count of the reference's ``"sort"`` engine.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from . import _kernels
from .hashing import u32

CMS_DEPTH = 4
CMS_WIDTH = 8192


def cms_init(
    depth: int = CMS_DEPTH,
    width: int = CMS_WIDTH,
    leading: tuple[int, ...] = (),
    device: "torch.device | str | None" = None,
) -> torch.Tensor:
    """Zeroed count table ``int32[*leading, depth, width]`` on ``device``
    (the card unless the caller names another)."""
    return torch.zeros(
        (*leading, depth, width), dtype=torch.int32, device=resolve_device(device)
    )


def cms_indices(
    hash_hi: torch.Tensor,
    hash_lo: torch.Tensor,
    depth: int = CMS_DEPTH,
    width: int = CMS_WIDTH,
) -> torch.Tensor:
    """Row indices ``int32[depth, B]``; ``width`` must be a power of two.
    ``lo + i·hi`` is formed in int64 and wraps modulo 2³² through the
    mask (the width divides 2³²)."""
    if width & (width - 1):
        raise ValueError("CMS width must be a power of two")
    hi = u32(hash_hi)
    lo = u32(hash_lo)
    rows = [((lo + i * hi) & (width - 1)).to(torch.int32) for i in range(depth)]
    return torch.stack(rows, dim=0)


def cms_update(
    table: torch.Tensor,
    idx: torch.Tensor,
    weight: torch.Tensor | None = None,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scatter-add a batch (``idx[D, B]``) into ``table[..., D, W]``.
    Invalid lanes add 0. Returns a new tensor."""
    d, w = table.shape[-2], table.shape[-1]
    b = idx.shape[-1]
    if weight is None:
        weight = torch.ones(b, dtype=table.dtype, device=table.device)
    weight = weight.to(table.dtype).expand(d, b)
    if valid is not None:
        weight = torch.where(valid[None, :], weight, 0)
    row_offset = torch.arange(d, device=table.device)[:, None] * w
    flat_idx = (idx.to(torch.int64) + row_offset).reshape(-1)
    flat = table.reshape(*table.shape[:-2], d * w).clone()
    src = weight.reshape(-1).expand(*flat.shape[:-1], d * b).contiguous()
    flat.index_add_(-1, flat_idx, src)
    return flat.reshape(table.shape)


def cms_hist_plain(flat: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Exact histogram of int keys → ``int32[n_bins]`` by sort and
    searchsorted; keys outside ``[0, n_bins)`` (the sentinel ``n_bins``
    among them) are not counted."""
    s = torch.sort(flat.to(torch.int64)).values
    edges = torch.arange(n_bins + 1, dtype=torch.int64, device=flat.device)
    cuts = torch.searchsorted(s, edges)
    return (cuts[1:] - cuts[:-1]).to(torch.int32)


# CMS rows a lane of the histogram kernel keeps in registers.
_HIST_MAX_ROWS = 8


def cms_count_plain(
    idx: torch.Tensor, valid: torch.Tensor | None, width: int
) -> torch.Tensor:
    """Plain version of :func:`cms_count`, built on :func:`cms_hist_plain`:
    lane ``i`` of row ``d`` takes the flat key ``d·width + idx[d, i]``, or
    the sentinel ``D·width`` when it is invalid or its index lies outside
    ``[0, width)``."""
    d = idx.shape[0]
    idx = idx.to(torch.int64)
    ok = (idx >= 0) & (idx < width)
    if valid is not None:
        ok = ok & valid[None, :]
    rows = torch.arange(d, dtype=torch.int64, device=idx.device)[:, None] * width
    flat = torch.where(ok, idx + rows, d * width)
    return cms_hist_plain(flat.reshape(-1), d * width).view(d, width)


def _launch_hist(name, idx, valid, width) -> torch.Tensor:
    """Validate, allocate the output (the kernel clears it) and launch."""
    if idx.device.type != "cuda":
        raise ValueError(f"{name} has no kernel for device {idx.device}")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError(f"{name} takes int32 keys [D, B]")
    d, b = idx.shape
    if d > _HIST_MAX_ROWS:
        raise ValueError(f"{name} keeps at most {_HIST_MAX_ROWS} rows a lane in registers")
    if valid is not None and (
        valid.device != idx.device or valid.dtype != torch.bool or valid.shape != (b,)
    ):
        raise ValueError(f"{name}: valid must be a bool [B] beside the keys")
    if width < 1 or d * width >= 1 << 31:
        raise ValueError(f"{name}: {d} x {width} bins do not fit int32 keys")
    out = torch.empty((d, width), dtype=torch.int32, device=idx.device)
    _kernels.launch_cms_hist(
        idx.contiguous(), None if valid is None else valid.contiguous(), width, out
    )
    return out


def cms_count(
    idx: torch.Tensor, valid: torch.Tensor | None, width: int
) -> torch.Tensor:
    """One batch's CMS count ``int32[D, width]``: for each row ``d``, the
    number of lanes with ``idx[d, i] == k``, invalid lanes (``valid``
    False) and indices outside ``[0, width)`` not counted; ``valid=None``
    counts every lane.

    CUDA tensor: the ``cms_hist`` kernel over ``idx[D, B]`` (int32,
    D <= 8), one launch. CPU tensor: :func:`cms_count_plain`.
    Anything else raises."""
    if idx.device.type == "cpu":
        return cms_count_plain(idx, valid, width)
    return _launch_hist("cms_count", idx, valid, width)


def cms_hist(flat: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Exact histogram of int32 keys → ``int32[n_bins]``; keys outside
    ``[0, n_bins)`` (the sentinel ``n_bins`` among them) are not counted.

    CUDA tensor: the ``cms_hist`` kernel as one row with no mask. CPU
    tensor: :func:`cms_hist_plain`. Anything else raises."""
    if flat.device.type == "cpu":
        return cms_hist_plain(flat, n_bins)
    if flat.dim() != 1:
        raise ValueError("cms_hist takes a 1-D int32 key tensor")
    return _launch_hist("cms_hist", flat.view(1, -1), None, n_bins).view(n_bins)


def cms_update_hist(
    table: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Unit-weight batch count of a 2-D ``table[D, W]``: identical to
    :func:`cms_update` with ``weight=None``, computed as a histogram
    (:func:`cms_count`)."""
    return table + cms_count(idx, valid, table.shape[1]).to(table.dtype)


def cms_query(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Point-query counts: ``min`` over the D rows. ``table[..., D, W]``,
    ``idx[D, B]`` → ``int32[..., B]``."""
    gathered = torch.gather(
        table, -1, idx.to(torch.int64).expand(*table.shape[:-2], *idx.shape)
    )
    return gathered.min(dim=-2).values


def cms_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CMS union: tables merge by elementwise addition (exact)."""
    return a + b


def cms_indices_np(
    hash_hi: np.ndarray,
    hash_lo: np.ndarray,
    depth: int = CMS_DEPTH,
    width: int = CMS_WIDTH,
) -> np.ndarray:
    """Host twin of :func:`cms_indices` in wrapping uint32."""
    if width & (width - 1):
        raise ValueError("CMS width must be a power of two")
    hi = hash_hi.astype(np.uint32)
    lo = hash_lo.astype(np.uint32)
    rows = []
    with np.errstate(over="ignore"):
        for i in range(depth):
            g = lo + np.uint32(i) * hi
            rows.append((g & np.uint32(width - 1)).astype(np.int32))
    return np.stack(rows, axis=0)


def cms_query_np(table: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Host twin of :func:`cms_query`."""
    gathered = np.take_along_axis(
        table, np.broadcast_to(idx, (*table.shape[:-2], *idx.shape)), axis=-1
    )
    return np.min(gathered, axis=-2)
