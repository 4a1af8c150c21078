"""Count-Min sketch on count tensors ``int32[..., D, W]``.

The table is global, with the service folded into the key hash. Row
hashes use the Kirsch–Mitzenmacher construction ``g_i = lo + i·hi``
(mod 2³²) from one 64-bit key hash. Update is a scatter-add, merge an
elementwise add, query a min over the D rows.

:func:`cms_hist` is the CMS count of the composed sketch path: on a CUDA
tensor it launches the hand-written histogram kernel
(``csrc/cms_hist.cu``); on a CPU tensor it runs :func:`cms_hist_plain`,
the sort/searchsorted count of the reference's ``"sort"`` engine.
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


def cms_hist(flat: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Exact histogram of int32 keys in ``[0, n_bins]`` → ``int32[n_bins]``.

    CUDA tensor: the ``cms_hist`` kernel. CPU tensor:
    :func:`cms_hist_plain`. Anything else raises."""
    if flat.device.type == "cpu":
        return cms_hist_plain(flat, n_bins)
    if flat.device.type != "cuda":
        raise ValueError(f"cms_hist has no kernel for device {flat.device}")
    if flat.dtype != torch.int32 or flat.dim() != 1:
        raise ValueError("cms_hist takes a 1-D int32 key tensor")
    counts = torch.zeros(n_bins, dtype=torch.int32, device=flat.device)
    _kernels.launch_cms_hist(flat.contiguous(), n_bins, counts)
    return counts


def cms_update_hist(
    table: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Unit-weight batch count of a 2-D ``table[D, W]``: identical to
    :func:`cms_update` with ``weight=None``, computed as a histogram.
    Invalid lanes take the key ``D·W``, one past the counted range."""
    d, w = table.shape
    row_offset = torch.arange(d, dtype=torch.int32, device=table.device)[:, None] * w
    flat_idx = idx.to(torch.int32) + row_offset
    if valid is not None:
        flat_idx = torch.where(valid[None, :], flat_idx, d * w)
    counts = cms_hist(flat_idx.reshape(-1), d * w)
    return table + counts.reshape(d, w).to(table.dtype)


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
