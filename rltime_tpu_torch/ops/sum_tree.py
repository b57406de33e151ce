"""Binary sum tree for prioritized replay (port of `ops/sum_tree.py`).

Layout, as in the JAX version: a flat `(2N,)` float32 tensor for N
(power-of-two) leaves. Node 1 is the root, node `i` has children `2i`
and `2i+1`, leaves occupy `[N, 2N)`, node 0 is unused padding. A JAX
tree crosses over as it is (`torch.from_numpy` of the `(2N,)` array).

The JAX version fixes the ancestors by propagating the leaves' DELTAS
with one scatter-add per level. On CUDA a scatter-add (`index_add_`) is
atomic and unordered, so leaves that share an ancestor would give float
sums that differ from run to run. Chosen here instead: the leaves are
written (duplicates resolved to the last occurrence, as in
`dense_tree.set_priorities`), then every touched ancestor is RECOMPUTED
from its two children, level by level. Touched leaves that share an
ancestor write the same value to it, so the result does not depend on
any ordering, no sort is needed when `unique=True`, and every node
stays exactly the float sum of its children (a delta chain drifts). On
dyadic priorities, where every sum is exact, the tree and the sampled
leaves are bit-equal to the JAX version's (tests/test_torch_sum_tree.py).

Out-of-range leaf indices are dropped, not wrapped (JAX's
`mode="drop"`): their writes go to a spare slot past the tree's end.
Randomness crosses in as tensors: `sample` takes its uniforms `u (B,)`.
"""
from __future__ import annotations

import torch


def tree_size(num_leaves: int) -> int:
    """Smallest power of two >= num_leaves."""
    n = 1
    while n < num_leaves:
        n *= 2
    return n


def init(num_leaves: int, device: torch.device | str = "cpu",
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """All-zero tree able to hold `num_leaves` priorities."""
    return torch.zeros((2 * tree_size(num_leaves),), dtype=dtype,
                       device=device)


def capacity(tree: torch.Tensor) -> int:
    return tree.shape[0] // 2


def total(tree: torch.Tensor) -> torch.Tensor:
    """Root value == sum of all priorities."""
    return tree[1]


def get(tree: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Read leaf priorities at `idx` (any shape)."""
    return tree[capacity(tree) + idx.long()]


def set_priorities(tree: torch.Tensor, idx: torch.Tensor,
                   priorities: torch.Tensor,
                   unique: bool = False) -> torch.Tensor:
    """Return a copy of `tree` with leaves `idx` (B,) set to `priorities`
    and all their ancestors fixed.

    Duplicate indices resolve to the LAST occurrence in input order (a
    stable sort, all but the last of a run routed to the spare slot).
    `unique=True` asserts the caller has no duplicates and skips the
    sort."""
    n = capacity(tree)
    depth = n.bit_length() - 1
    idx = idx.long()
    priorities = priorities.to(tree.dtype)
    live = (idx >= 0) & (idx < n)
    if not unique:
        idx, order = torch.sort(idx, stable=True)
        priorities, live = priorities[order], live[order]
        live = live & torch.cat([
            idx[1:] != idx[:-1],
            torch.ones(1, dtype=torch.bool, device=idx.device)])
    spare = 2 * n
    buf = torch.cat([tree, tree.new_zeros(1)])
    node = n + torch.clamp(idx, 0, n - 1)
    buf[torch.where(live, node, spare)] = priorities
    # every level's parents at once: (depth, B), leaf parents .. root
    shifts = torch.arange(1, depth + 1, device=idx.device)[:, None]
    parents = node[None, :] >> shifts
    targets = torch.where(live[None, :], parents, spare)
    pairs = buf[:spare].view(n, 2)      # pairs[p] = (buf[2p], buf[2p+1])
    for lvl in range(depth):
        buf[targets[lvl]] = pairs[parents[lvl]].sum(dim=1)
    return buf[:spare]


def _descend(tree: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Prefix-sum targets -> leaf indices, the whole batch in lockstep.

    Zero-subtree-proof: a float-boundary target (t == the left subtree's
    sum exactly) must not step into an empty right subtree, nor the
    reverse, or the caller would sample a zero-priority leaf. Each level
    checks the child masses, not just the target."""
    n = capacity(tree)
    depth = n.bit_length() - 1
    pairs = tree.view(n, 2)
    idx = torch.ones_like(targets, dtype=torch.int64)
    t = targets
    for _ in range(depth):
        left, right = pairs[idx].unbind(dim=1)
        go_right = ((t >= left) & (right > 0)) | (left <= 0)
        t = torch.where(go_right, t - left, t)
        idx = 2 * idx + go_right.long()
    return idx - n


def sample(tree: torch.Tensor, u: torch.Tensor, stratified: bool = True):
    """Draw len(u) leaves ~ priority / total (stratified by default:
    target i is uniform in segment [i, i+1)/B of the total mass).

    `u` (B,) holds uniforms in [0, 1) of the tree's dtype. Returns
    (leaf_idx (B,) int64, leaf_priority (B,))."""
    tot = total(tree)
    batch = u.shape[0]
    u = u.to(tree.dtype)
    if stratified:
        u = (torch.arange(batch, dtype=tree.dtype, device=tree.device)
             + u) / batch
    # the nextafter guard keeps targets strictly below the total, so the
    # descend cannot fall off the right edge
    targets = torch.minimum(u * tot,
                            torch.nextafter(tot, torch.zeros_like(tot)))
    idx = _descend(tree, targets)
    return idx, get(tree, idx)
