"""Row gathers, forward only (counterpart of ``ops/lookup.py``).

The JAX package wraps its gathers in custom VJPs whose backward avoids
the TPU's serial scatter-add, and computes small-table gathers as a
select-sum because TPU row gathers are slow. On the card a gather is a
plain indexed load, so the forward is ``table[idx]``; the backward comes
with the differentiable train step.
"""

from __future__ import annotations


def table_lookup(table, idx):
    """``table[idx]``: [N, K], [R] int -> [R, K]; idx must be in range."""
    return table.index_select(0, idx.long())


def atlas_lookup(atlas, flat_idx):
    """``atlas.reshape(rows*W, C)[flat_idx]``: [rows, W, C], [R] -> [R, C]."""
    rows, w, c = atlas.shape
    return atlas.reshape(rows * w, c).index_select(0, flat_idx.long())
