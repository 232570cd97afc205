"""Paged KV cache: fixed-size blocks, a free-list allocator, per-request
block tables and placement-aware residency (port of
``repro.serving.kvcache``).

The cache of every attention layer is a pool whose leading axes are
``(num_blocks, block_size)`` instead of ``(batch, max_len)``: the pools
tree is ``init_cache(cfg, batch=num_blocks, max_len=block_size)``. A
request's KV sequence is the concatenation of the blocks its block table
names. Block 0 is the null block: unallocated table entries and padded
batch rows point at it, so gathers read zeros (masked off by causal
attention) and scatters from inactive rows land in scratch.

The decode step per tick:

    dense   = gather_pages(pools, block_tables)      # (B, W*bs, ...)
    logits, dense = decode_step(cfg, params, dense, tokens, lengths)
    scatter_token(pools, dense, block_tables, lengths)   # in place

The reference donates the pools to its jitted step and gets new ones
back; here :func:`scatter_token` and :func:`write_prompt` update the
pool tensors in place, which is what donation bought there.

Under a plan (:func:`place_pools`) each pool leaf lives on the device of
the PE the plan assigns the leaf's input node; the helpers above move
what they write to the pool's device.
"""
from __future__ import annotations

import torch

from ..tree import tree_flatten, tree_map_with_path, tree_unflatten

#: block id every unallocated table entry (and padded row) points at
NULL_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """The free list is empty — caller must evict or wait."""


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size blocks.

    Block ids ``[0, reserved)`` are never handed out (block 0 is the
    null block). Allocation is LIFO over the free list; the invariants
    — no double allocation, no foreign/double free, conservation of
    ``num_free + num_allocated`` — are checked on every operation and
    by :meth:`check`.
    """

    def __init__(self, num_blocks: int, reserved: int = 1):
        if num_blocks <= reserved:
            raise ValueError(
                f"need more than {reserved} blocks (got {num_blocks})")
        self.num_blocks = int(num_blocks)
        self.reserved = int(reserved)
        self._free: list[int] = list(range(num_blocks - 1,
                                           self.reserved - 1, -1))
        self._allocated: set[int] = set()
        self.peak_in_use = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_in_use(self) -> int:
        return len(self._allocated)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (total minus reserved)."""
        return self.num_blocks - self.reserved

    def alloc(self) -> int:
        if not self._free:
            raise OutOfBlocks(
                f"all {self.capacity} KV blocks in use — evict a request "
                f"or raise num_blocks")
        b = self._free.pop()
        self._allocated.add(b)
        self.peak_in_use = max(self.peak_in_use, self.num_in_use)
        return b

    def alloc_many(self, n: int) -> list[int]:
        if n > self.num_free:
            raise OutOfBlocks(
                f"need {n} KV blocks, only {self.num_free} free")
        return [self.alloc() for _ in range(n)]

    def free(self, block: int) -> None:
        if block not in self._allocated:
            raise ValueError(
                f"block {block} is not allocated (double free or foreign "
                f"block)")
        self._allocated.remove(block)
        self._free.append(block)

    def free_many(self, blocks: list[int]) -> None:
        for b in blocks:
            self.free(b)

    def check(self) -> None:
        """Assert the allocator invariants."""
        free = set(self._free)
        assert len(free) == len(self._free), "free list has duplicates"
        assert not (free & self._allocated), \
            "block both free and allocated"
        assert free | self._allocated == set(
            range(self.reserved, self.num_blocks)), "blocks lost"


# ---------------------------------------------------------------------------
# pool tree helpers
# ---------------------------------------------------------------------------
def supported_reason(cfg) -> str | None:
    """None when ``cfg`` can serve through the paged cache, else why not.

    Paging needs every cache leaf to carry a sequence axis. Recurrent
    kinds (mamba/rwkv) keep O(1) state with no sequence axis to page;
    encoder-only archs have no decode step; non-token frontends have no
    prompt tokens to prefill.
    """
    if cfg.encoder_only:
        return "encoder-only arch has no decode step"
    if cfg.frontend is not None:
        return "non-token frontend has no token prompts to serve"
    if not cfg.causal:
        return "non-causal attention cannot decode autoregressively"
    kinds = tuple(cfg.prelude) + tuple(cfg.block_pattern)
    bad = sorted({k for k in kinds
                  if k == "rwkv" or k.startswith("mamba")})
    if bad:
        return (f"recurrent layer kinds {bad} keep O(1) state with no "
                f"sequence axis to page")
    return None


def init_pools(cfg, num_blocks: int, block_size: int, device=None):
    """The paged pools tree: ``init_cache`` with the batch axis
    reinterpreted as blocks and the sequence axis as the within-block
    offset."""
    from ..models import init_cache
    reason = supported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(
            f"{cfg.name}: paged serving unsupported — {reason}")
    return init_cache(cfg, num_blocks, block_size, device)


def _bdim(path) -> int:
    """Block axis of a pool leaf (batch axis of the dense view): leaves
    under ``periods`` are stacked with a leading num_periods axis."""
    return 1 if "periods" in path else 0


def gather_pages(pools, block_tables: torch.Tensor):
    """Pools → dense per-request caches via the block tables.

    ``block_tables``: (B, W) int, entries are block ids (NULL_BLOCK where
    unallocated). Each leaf ``(..., nb, bs, *t)`` becomes
    ``(..., B, W*bs, *t)`` — the contiguous layout ``decode_step``
    expects, with ``max_len = W * block_size``. The result is a fresh
    tensor per leaf (the transient dense view of one step).
    """
    B, W = block_tables.shape
    flat_ids = block_tables.reshape(-1).long()

    def one(path, pool):
        b = _bdim(path)
        dense = pool.index_select(b, flat_ids.to(pool.device))
        shape = dense.shape
        return dense.reshape(shape[:b] + (B, W * shape[b + 1])
                             + shape[b + 2:])
    return tree_map_with_path(one, pools)


def scatter_token(pools, new_dense, block_tables: torch.Tensor,
                  lengths: torch.Tensor):
    """Write back, in place, the one token each row appended at position
    ``lengths[r]`` of its dense view into block
    ``block_tables[r, lengths[r] // bs]`` at offset ``lengths[r] % bs``.

    Rows whose table maps the position to the null block (padding /
    inactive rows) all write into it: the destinations repeat, so the
    write assigns (one of the rows wins) and never accumulates; nothing
    reads unmasked null content. Returns the pools tree (the same
    tensors).
    """
    def one(path, pool, dense):
        b = _bdim(path)
        bs = pool.shape[b + 1]
        nb = pool.shape[b]
        bt = block_tables.to(pool.device).long()
        lens = lengths.to(pool.device).long()
        rows = torch.arange(bt.shape[0], device=pool.device)
        dest = bt[rows, lens // bs] * bs + lens % bs          # (B,)
        flat = pool.view(pool.shape[:b] + (nb * bs,) + pool.shape[b + 2:])
        if b == 0:
            flat[dest] = dense[rows, lens].to(flat.dtype)
        else:
            flat[:, dest] = dense[:, rows, lens].to(flat.dtype)
        return pool
    return tree_map_with_path(one, pools, new_dense)


def write_prompt(pools, blocks: list[int], dense_caches, row: int,
                 plen: int, block_size: int):
    """Copy one prefilled request's cache rows ``[0, plen)`` from the
    dense prefill caches (row ``row``) into its allocated ``blocks``, in
    place. Returns the pools tree (the same tensors)."""
    nfull, rem = divmod(plen, block_size)
    if nfull + (rem > 0) > len(blocks):
        raise ValueError(f"{plen} tokens need {nfull + (rem > 0)} blocks, "
                         f"request holds {len(blocks)}")

    def one(path, pool, dense):
        b = _bdim(path)
        drow = dense.select(b, row)                       # (..., S, *t)
        pre = (slice(None),) * b
        if nfull:
            ids = torch.as_tensor(blocks[:nfull], device=pool.device)
            src = drow[pre + (slice(0, nfull * block_size),)]
            src = src.reshape(src.shape[:b] + (nfull, block_size)
                              + src.shape[b + 1:])
            pool[pre + (ids,)] = src.to(pool.device, pool.dtype)
        if rem:
            lo = nfull * block_size
            pool[pre + (blocks[nfull], slice(0, rem))] = \
                drow[pre + (slice(lo, plen),)].to(pool.device, pool.dtype)
        return pool
    return tree_map_with_path(one, pools, dense_caches)


# ---------------------------------------------------------------------------
# placement-aware residency
# ---------------------------------------------------------------------------
def resolve_pool_devices(plan, n_params_leaves: int, pools,
                         devices: list) -> list:
    """Device for every pool leaf under ``plan``: the device of the PE
    the plan assigns the leaf's graph input node to.

    The traced decode function's flat inputs are
    ``(params..., pools..., block_tables, tokens, lengths)``, so pool
    leaf ``i`` is input node ``input_nodes[n_params_leaves + i]``.
    """
    prog = plan.traced.program
    n = len(tree_flatten(pools)[0])
    return [devices[int(plan.assignment[
        prog.input_nodes[n_params_leaves + i]])] for i in range(n)]


def place_pools(plan, n_params_leaves: int, pools, devices: list):
    """Move every pool leaf onto its plan-resolved device. Returns
    (placed_pools, leaf_devices)."""
    devs = resolve_pool_devices(plan, n_params_leaves, pools, devices)
    leaves, structure = tree_flatten(pools)
    placed = [leaf.to(d) for leaf, d in zip(leaves, devs)]
    return tree_unflatten(structure, placed), devs


__all__ = [
    "NULL_BLOCK", "OutOfBlocks", "BlockAllocator", "supported_reason",
    "init_pools", "gather_pages", "scatter_token", "write_prompt",
    "resolve_pool_devices", "place_pools",
]
