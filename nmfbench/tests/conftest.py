"""The benchmark's CPU tests: ``python -m pytest nmfbench/tests -q`` from
the checkout's root (the card tests carry the ``cuda`` marker and skip
without a card)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

WORKLOADS = ("pbmc68k.vb_pallas", "pbmc8k.vb_pallas", "pbmc68k.vb_sparse")


def small(workload, n=128, m=400, ranks=(2, 3, 4), nrun=3, itmax=30):
    """The cell's files with the counts and the scan cut to a size the
    CPU runs in a second: (spec, workload, config, traffic, limits)."""
    from nmfbench import harness

    spec, wl, cfg, traffic, limits = harness.cell(workload)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["data"].update(n_genes=n, n_cells=m)
    traffic.update(ranks=list(ranks), nrun=nrun, Itmax=itmax)
    return spec, wl, cfg, traffic, limits


@pytest.fixture
def small_cell():
    return small
