"""The work a VB sweep needs, counted from shapes, live ranks and X's
nonzeros, whatever implements it; and the least time the card could
take for it.

A sweep of one lane of live rank r over X (n genes x m cells, nnz
nonzeros) needs, at each nonzero, the model value sum_k lw_ik lh_kj and
the two statistics' terms a_ij lh_kj and a_ij lw_ik: 3 r multiply-adds,
6 r operations.  Its bytes are X's nonzeros at one byte each and each
factor array the sweep must read (lw, lh) and write (ew, lw, dw, eh,
lh, dh) once, in the factor type: four arrays of the W family (n x r)
and four of the H family (r x m).  Zeros of X, padded ranks, partial
sums and reads again are not counted, so the bound holds for a sweep
that skips X's zeros, fuses kernels or runs on tensor cores.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"
FAMILY_ARRAYS = 4           # W's lw read, ew, lw, dw written; H's alike


def sweep_flops(nnz, live_ranks):
    """Operations one sweep of lanes of live ranks ``live_ranks`` needs."""
    return 6 * sum(int(r) for r in live_ranks) * int(nnz)


def sweep_bytes(n, m, nnz, live_ranks, itemsize=4):
    """Bytes one sweep of those lanes needs to move."""
    return int(nnz) + FAMILY_ARRAYS * (int(n) + int(m)) * sum(
        int(r) for r in live_ranks) * int(itemsize)


def peaks(kind):
    """The card's dense peaks ``{"flops": ..., "bytes": ...}`` (per
    second) from ``peaks.json``, None for a card not in the table."""
    table = json.loads(PEAKS_FILE.read_text())
    return table["cards"].get(kind)


def bound_seconds(flops, nbytes, peak):
    """The least time: the larger of operations over the peak rate and
    bytes over the peak bandwidth."""
    return max(flops / peak["flops"], nbytes / peak["bytes"])
