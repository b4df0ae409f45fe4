"""The collectives of lora_tpu_torch.parallel, in one place.

torch.distributed is multi-controller: every rank holds its local block and
calls the same collective with it.  The port takes two backends: NCCL on the
card, and gloo on the CPU and for ranks that share one card (NCCL refuses
two ranks on one device).  gloo has no send/recv for CUDA tensors, so the
neighbour exchanges of halo.py and channelize.py ride `all_to_all_single`
with split sizes (a permutation: each rank sends its block to one peer),
which both backends take for CPU and CUDA tensors.  Gathers ride
`all_gather` (the list form, which gloo takes for CUDA tensors where the
flat `all_gather_into_tensor` is not in every torch version), and the one
reduction `all_reduce`.  Every tensor but the reduced one moves as its bytes
(uint8): exact for any dtype, and NCCL has no int16 or bool.

`group=None` is the one-rank mesh without a process group: every call is
the identity there, as the JAX package's collectives are on one device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a tensor, flat uint8 (a view where t is contiguous)."""
    flat = t.reshape(-1)
    if flat.numel() < 2 or flat.stride(0) != 1:  # a [1] view may have any
        flat = flat.new_empty(flat.shape).copy_(flat)  # stride
    return flat.view(torch.uint8)


def from_bytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """The tensor whose bytes are b (a view where b is aligned for dtype)."""
    if b.storage_offset() % dtype.itemsize:
        b = b.clone()
    return b.view(dtype).reshape(shape)


def shift(x: torch.Tensor, group, by: int) -> torch.Tensor:
    """Send x to the rank `by` places on in the group (cyclically) and
    return the block that arrives from the rank `by` places back.  Every
    rank's x has one shape and dtype.  One all_to_all_single."""
    if group is None or x.numel() == 0:
        return x
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    src = as_bytes(x)
    out = torch.empty_like(src)
    send = [0] * n
    recv = [0] * n
    send[(me + by) % n] = src.numel()
    recv[(me - by) % n] = src.numel()
    dist.all_to_all_single(out, src, recv, send, group=group)
    return from_bytes(out, x.dtype, x.shape)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...]: block j goes to rank j of the group; returns [n, ...]
    whose block i came from rank i.  One all_to_all_single."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all: leading axis {x.shape[0]} != {n} ranks")
    src = as_bytes(x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return from_bytes(out, x.dtype, x.shape)


def all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's x (one shape and dtype), in group rank order.  One
    all_gather."""
    if group is None:
        return [x]
    n = dist.get_world_size(group)
    src = as_bytes(x)
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    return [from_bytes(o, x.dtype, x.shape) for o in outs]


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's x (a numeric dtype both backends reduce:
    float64 here).  One all_reduce."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out
