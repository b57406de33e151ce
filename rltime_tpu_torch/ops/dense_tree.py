"""Dense two-level prioritized sampler (port of `ops/dense_tree.py`).

One flat (N,) priority array viewed as (num_blocks, block) with
block ~ sqrt(N); sampling takes block sums, an inclusive cumsum, a
count-<=-target block pick, then a cumsum inside the picked rows. All
dense tensor ops with static shapes, so a later PR can capture the
update step in a CUDA graph.

Randomness crosses in as tensors: `sample` takes its uniforms `u (B,)`
so tests can feed it JAX's draws.
"""
from __future__ import annotations

import torch


def _block_shape(n: int) -> tuple[int, int]:
    """(num_blocks, block) for an already-padded n."""
    bs = 128
    while bs * bs < n:
        bs *= 2
    if n % bs != 0:
        raise ValueError("tree not allocated via dense_tree.init")
    return n // bs, bs


def padded_size(num_leaves: int) -> int:
    bs = 128
    while bs * bs < num_leaves:
        bs *= 2
    return ((num_leaves + bs - 1) // bs) * bs


def init(num_leaves: int, device: torch.device | str = "cpu",
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """All-zero flat priority array; padding leaves stay zero forever
    and the sampling math can never return them."""
    return torch.zeros((padded_size(num_leaves),), dtype=dtype,
                       device=device)


def total(tree: torch.Tensor) -> torch.Tensor:
    return torch.sum(tree)


def get(tree: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tree[idx.long()]


def set_priorities(tree: torch.Tensor, idx: torch.Tensor,
                   priorities: torch.Tensor,
                   unique: bool = False) -> torch.Tensor:
    """Return a copy of `tree` with leaves `idx` (B,) set to `priorities`.

    Duplicate indices resolve to the LAST occurrence in input order. A
    plain `index_put_` with duplicates is unordered on CUDA, so the
    indices are stably sorted and every duplicate but the last is routed
    to a spare slot N of an (N+1,) buffer that is sliced off (JAX's
    `mode="drop"`, with static shapes). `unique=True` asserts the caller
    has no duplicates and skips the sort."""
    n = tree.shape[0]
    idx = idx.long()
    priorities = priorities.to(tree.dtype)
    buf = torch.cat([tree, tree.new_zeros(1)])
    if unique:
        buf[idx] = priorities
        return buf[:n]
    sidx, order = torch.sort(idx, stable=True)
    sp = priorities[order]
    keep = torch.cat([sidx[1:] != sidx[:-1],
                      torch.ones(1, dtype=torch.bool, device=idx.device)])
    sidx = torch.where(keep, sidx, torch.full_like(sidx, n))
    buf[sidx] = sp
    return buf[:n]


def sample(tree: torch.Tensor, u: torch.Tensor, stratified: bool = True):
    """Draw len(u) leaves ~ priority / total (stratified by default).

    `u` (B,) holds uniforms in [0, 1) of the tree's dtype. Returns
    (leaf_idx (B,) int64, leaf_priority (B,))."""
    n = tree.shape[0]
    batch = u.shape[0]
    nb, bs = _block_shape(n)
    rows = tree.view(nb, bs)
    block_sums = torch.sum(rows, dim=1)          # (nb,)
    cumb = torch.cumsum(block_sums, dim=0)       # (nb,) inclusive
    # Scale AND clamp against cumb[-1], the value the block search
    # compares with, so no target routes past every live block.
    tot = cumb[-1]
    u = u.to(tree.dtype)
    if stratified:
        u = (torch.arange(batch, dtype=tree.dtype, device=tree.device)
             + u) / batch
    targets = torch.minimum(u * tot,
                            torch.nextafter(tot, torch.zeros_like(tot)))
    # smallest block with cumb > target == #{cumb <= target}
    blk = torch.sum(cumb[None, :] <= targets[:, None], dim=1)
    blk = torch.clamp(blk, max=nb - 1)
    t_in = targets - (cumb[blk] - block_sums[blk])
    picked = rows[blk]                           # (B, bs) row gather
    cumr = torch.cumsum(picked, dim=1)
    off = torch.sum(cumr <= t_in[:, None], dim=1)
    off = torch.clamp(off, max=bs - 1)
    leaf = blk * bs + off
    return leaf, tree[leaf]
