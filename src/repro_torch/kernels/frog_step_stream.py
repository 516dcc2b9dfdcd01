"""The streamed superstep's graph layout (port of the layout half of
``repro/kernels/frog_step_stream.py``; the kernel is
``csrc/frog_step_stream.cu`` and its wrapper ``ops.frog_step_stream_sorted``).

:class:`BlockedCSR` re-lays the CSR out as uniform per-vertex-block slabs:
``row_off[v, i]`` is vertex ``v·BV + i``'s offset into block ``v``'s edge
slab, ``deg[v, i]`` its out-degree (0 past ``n``), and ``col[v, :]`` the
block's edge destinations packed at the front, zeros after. The slab width
``E_blk`` is the largest block's edge count rounded up to a multiple of 8,
so every block's slab has one shape. The arrays equal the reference's,
zero tails included; :func:`block_csr` builds them with tensor operations
on the graph's device instead of a Python loop over the blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DEFAULT_VERTEX_BLOCK = 512


@dataclasses.dataclass(frozen=True)
class BlockedCSR:
    """CSR as per-vertex-block slabs.

    Attributes:
      vertex_block: BV, vertices per slab.
      row_off: int32[num_vb, BV], ``row_ptr[v] - row_ptr[v0]`` of each
        vertex within its block.
      deg:     int32[num_vb, BV], out-degrees (0 for pad vertices ≥ n).
      col:     int32[num_vb, E_blk], edge destinations (global vertex ids),
        each block's edges at the front, zeros after.
    """

    vertex_block: int
    row_off: torch.Tensor
    deg: torch.Tensor
    col: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return int(self.row_off.shape[0])

    @property
    def n_pad(self) -> int:
        return self.num_blocks * self.vertex_block

    @property
    def e_blk(self) -> int:
        return int(self.col.shape[1])

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.row_off, self.deg, self.col))


def _geometry(n: int, vertex_block: int):
    bv = min(vertex_block, max(8, n))
    return bv, -(-n // bv)


def _block_nnz(row_ptr: torch.Tensor, n: int, vertex_block: int
               ) -> torch.Tensor:
    """int64[num_vb] edge count of each vertex block."""
    bv, num_vb = _geometry(n, vertex_block)
    rp = row_ptr.long()
    edges = torch.clamp_max(
        torch.arange(num_vb + 1, device=rp.device) * bv, n)
    bounds = rp[edges]
    return bounds[1:] - bounds[:-1]


def max_block_nnz(row_ptr: torch.Tensor, n: int, vertex_block: int) -> int:
    """Largest per-vertex-block edge count (at least 1): the natural slab
    width for :func:`block_csr`."""
    return int(max(1, int(_block_nnz(row_ptr, n, vertex_block).max())))


def round_e_blk(natural: int) -> int:
    """Slab-width alignment: a multiple of 8, at least 8."""
    return max(8, -(-int(natural) // 8) * 8)


def block_csr(row_ptr: torch.Tensor, col_idx: torch.Tensor,
              deg: torch.Tensor, n: int,
              vertex_block: int = DEFAULT_VERTEX_BLOCK,
              e_blk: Optional[int] = None) -> BlockedCSR:
    """The slab layout of a CSR, on ``row_ptr``'s device. ``e_blk`` forces
    a slab width (at least :func:`max_block_nnz`)."""
    dev = row_ptr.device
    bv, num_vb = _geometry(n, vertex_block)
    rp = row_ptr.long()
    block_nnz = _block_nnz(row_ptr, n, vertex_block)
    natural = int(max(1, int(block_nnz.max())))
    if e_blk is None:
        e_blk = round_e_blk(natural)
    elif e_blk < natural:
        raise ValueError(f"e_blk={e_blk} < max per-block nnz {natural}")
    v = torch.arange(n, device=dev)
    first = rp[(v // bv) * bv]               # row_ptr of each block's start
    row_off = torch.zeros(num_vb * bv, dtype=torch.int32, device=dev)
    row_off[:n] = (rp[:n] - first).to(torch.int32)
    deg_b = torch.zeros(num_vb * bv, dtype=torch.int32, device=dev)
    deg_b[:n] = deg[:n].to(torch.int32)
    # edge e of block b lands at col[b, e - row_ptr[b·BV]]
    total = int(block_nnz.sum())
    blk = torch.repeat_interleave(torch.arange(num_vb, device=dev),
                                  block_nnz, output_size=total)
    lo = rp[torch.clamp_max(torch.arange(num_vb, device=dev) * bv, n)]
    e = rp[0] + torch.arange(total, device=dev)
    col_b = torch.zeros(num_vb * e_blk, dtype=torch.int32, device=dev)
    col_b[blk * e_blk + (e - lo[blk])] = col_idx[e].to(torch.int32)
    return BlockedCSR(vertex_block=bv, row_off=row_off.reshape(num_vb, bv),
                      deg=deg_b.reshape(num_vb, bv),
                      col=col_b.reshape(num_vb, e_blk))


def blocked_csr_of(g, vertex_block: int = DEFAULT_VERTEX_BLOCK
                   ) -> BlockedCSR:
    """:func:`block_csr` of a :class:`~repro_torch.graph.csr.CSRGraph`."""
    return block_csr(g.row_ptr, g.col_idx, g.out_deg, g.n,
                     vertex_block=vertex_block)
