"""Ring merges over a process group — the long-haul sketch path.

Inside a host the direct all-reduce is the right merge (NCCL picks its
own algorithm over NVLink; see ``ops.collectives``). Across hosts
bandwidth is scarcer and latency lumpier, so the merge is the classic
two-phase ring all-reduce, each hop one neighbour exchange: a
reduce-scatter (n-1 hops), then an all-gather (n-1 hops), each hop moving
1/n of the state — bandwidth-optimal. Sketch states are associative
monoids, so the ring only has to reduce, never rotate.

Each hop is one ``batch_isend_irecv`` (send to the right neighbour,
receive from the left) inside the group; group ranks map to global ranks
with ``dist.get_global_rank``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _exchange(payload, right, left, group, host_staged):
    """Send ``payload`` to ``right`` and receive a chunk of the same shape
    from ``left``."""
    if host_staged:
        # gloo's send/recv take host tensors only: this hop goes through
        # host memory and back.
        send = payload.cpu()
    else:
        send = payload.contiguous()
    recv = torch.empty_like(send)
    ops = [
        dist.P2POp(dist.isend, send, right, group),
        dist.P2POp(dist.irecv, recv, left, group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(payload.device) if host_staged else recv


def _ring_allreduce(x, group, op, host_staged=False):
    """Bandwidth-optimal ring all-reduce of ``x`` over ``group``.

    Chunking is along the flattened tensor, padded to ``n`` chunks."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    me = dist.get_rank(group)
    right = dist.get_global_rank(group, (me + 1) % n)
    left = dist.get_global_rank(group, (me - 1) % n)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    chunks = torch.cat([flat, flat.new_zeros(pad)]).reshape(n, -1)

    # Reduce-scatter: at hop k this rank folds the partial of chunk
    # (me - k - 1) mod n arriving from the left into its own copy.
    for k in range(n - 1):
        recvd = _exchange(chunks[(me - k) % n], right, left, group, host_staged)
        dst = (me - k - 1) % n
        chunks[dst] = op(chunks[dst], recvd)
    # This rank now owns the reduced chunk (me + 1) mod n; circulate the
    # owned chunks around the ring.
    for k in range(n - 1):
        recvd = _exchange(chunks[(me - k + 1) % n], right, left, group, host_staged)
        chunks[(me - k) % n] = recvd
    out = chunks.reshape(-1)[: flat.numel()]
    return out.reshape(x.shape)


def ring_merge_max(x, group, host_staged=False):
    """Ring all-reduce with max — HLL register union across hosts."""
    return _ring_allreduce(x, group, torch.maximum, host_staged)


def ring_merge_sum(x, group, host_staged=False):
    """Ring all-reduce with add — CMS/count union across hosts."""
    return _ring_allreduce(x, group, torch.add, host_staged)


def merge_states_across(group, hll_bank, cms_bank, use_ring=True, host_staged=False):
    """Merge sketch banks across ``group`` (the replay/recovery path).

    With ``use_ring`` the merge is the neighbour-hop ring; otherwise one
    direct all-reduce each (max for HLL, sum for CMS), in place."""
    if use_ring:
        return (
            ring_merge_max(hll_bank, group, host_staged),
            ring_merge_sum(cms_bank, group, host_staged),
        )
    hll_bank, cms_bank = hll_bank.contiguous(), cms_bank.contiguous()
    dist.all_reduce(hll_bank, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(cms_bank, op=dist.ReduceOp.SUM, group=group)
    return hll_bank, cms_bank
