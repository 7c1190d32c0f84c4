"""Row gathers with the JAX package's backward passes (counterpart of
``ops/lookup.py``).

The forward is a plain indexed load. The backward is a scatter-add of the
output cotangent into the table, computed as the JAX package computes it:

* ``table_lookup`` — tables of at most ``ONEHOT_MAX_ROWS`` rows (material,
  sphere and small triangle packs) take the one-hot product
  ``onehot^T @ g``, chunked so that one chunk's one-hot block stays near
  ``ONEHOT_BLOCK_ELEMS`` elements (lookup.py:69-110); larger tables take
  the dense histogram (ops/histogram.py).
* ``atlas_lookup`` — the shading atlas always takes the dense histogram
  (lookup.py:144-148).

The TPU's select-sum forward for tiny tables was a workaround for slow
TPU gathers and is not ported.
"""

from __future__ import annotations

import torch

from sexy_raytracer_tpu_torch.ops import histogram

# tables with at most this many rows get the one-hot backward; larger ones
# the dense histogram (lookup.py:24-27)
ONEHOT_MAX_ROWS = 1024
# elements of one backward chunk's [chunk, rows] one-hot block
ONEHOT_BLOCK_ELEMS = 1 << 24


def table_lookup(table, idx):
    """``table[idx]``: [N, K], [R] int -> [R, K]; idx must be in range."""
    return _TableLookup.apply(table, idx)


class _TableLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, idx.long())

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _table_grad(idx, g, ctx.n_rows), None


def _table_grad(idx, g, n_rows):
    """The cotangent of a [n_rows, K] table gathered at ``idx`` [R], given
    the output cotangent ``g`` [R, K] (lookup.py:69-110)."""
    R = idx.shape[0]
    g32 = g.to(torch.float32).reshape(R, -1)
    if n_rows > ONEHOT_MAX_ROWS:
        return histogram.dense_histogram(idx, g32, n_rows).to(g.dtype)
    chunk = max(1, min(max(ONEHOT_BLOCK_ELEMS // max(n_rows, 1), 8192), R))
    rows = torch.arange(n_rows, dtype=idx.dtype, device=idx.device)
    out = torch.zeros((n_rows, g32.shape[1]), dtype=torch.float32,
                      device=g.device)
    for c0 in range(0, R, chunk):
        onehot = (idx[c0:c0 + chunk, None] == rows).to(torch.float32)
        out = out + onehot.T @ g32[c0:c0 + chunk]
    return out.to(g.dtype)


def atlas_lookup(atlas, flat_idx):
    """``atlas.reshape(rows*W, C)[flat_idx]``: [rows, W, C], [R] -> [R, C],
    with the dense-histogram backward."""
    return _AtlasLookup.apply(atlas, flat_idx)


class _AtlasLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, atlas, flat_idx):
        ctx.save_for_backward(flat_idx)
        ctx.shape = atlas.shape
        rows, w, c = atlas.shape
        return atlas.reshape(rows * w, c).index_select(0, flat_idx.long())

    @staticmethod
    def backward(ctx, g):
        (flat_idx,) = ctx.saved_tensors
        rows, w, c = ctx.shape
        d = histogram.dense_histogram(flat_idx, g.to(torch.float32),
                                      rows * w)
        return d.reshape(rows, w, c).to(g.dtype), None
