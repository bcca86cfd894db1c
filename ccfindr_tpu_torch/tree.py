"""Rank-hierarchy cluster tree.

Equivalent of reference R/tree.R: clusters at consecutive ranks are
linked by argmax of the (r-1) x r contingency table of hard
assignments, grown into a nested tree from the rank-2 root, serialized
to Newick, and plotted as a dendrogram.

Tree representation: a *node list*; each element is either
* a leaf label string "rank.cluster" (1-based cluster ids), or
* an internal node tuple (name, children) where children is a node
  list — mirroring R's named nested lists.
"""

from __future__ import annotations

import numpy as np

from .container import SCSet


def _rank_of(label: str) -> int:
    return int(label.split(".")[0])


def newick(tree, parent: str = "1.1", _root: bool = True) -> str:
    """Serialize a tree to Newick with branch length = rank difference
    (reference R/tree.R:16-38)."""
    parts = []
    for node in tree:
        if isinstance(node, str):
            bl = _rank_of(node) - _rank_of(parent)
            parts.append(f"{node}:{bl}")
        else:
            name, children = node
            bl = _rank_of(name) - _rank_of(parent)
            sub = newick(children, parent=name, _root=False)
            parts.append(f"{sub}{name}:{bl}")
    s = "(" + ",".join(parts) + ")"
    if _root:
        s += ";"
    return s


def branch_tree(tree, parent_id: str, progenies):
    """Replace the leaf ``parent_id`` with an internal node carrying
    ``progenies`` as children (reference R/tree.R:41-54)."""
    out = []
    for node in tree:
        if isinstance(node, str):
            if node == parent_id:
                out.append((parent_id, list(progenies)))
            else:
                out.append(node)
        else:
            name, children = node
            out.append((name, branch_tree(children, parent_id,
                                          progenies)))
    return out


def update_tree(tree, parent_ids, progenies):
    """Rename leaves in ``parent_ids`` to the matching ``progenies``
    (reference R/tree.R:56-65)."""
    mapping = dict(zip(parent_ids, progenies))
    out = []
    for node in tree:
        if isinstance(node, str):
            out.append(mapping.get(node, node))
        else:
            name, children = node
            out.append((name, update_tree(children, parent_ids,
                                          progenies)))
    return out


def build_tree(object: SCSet, rmax: int | None = None):
    """Build the cluster hierarchy across ranks 2..rmax
    (reference R/tree.R:80-127).

    Requires a contiguous rank scan starting at 2 (the rank-2 root
    split is the anchor, as in the reference).
    """
    r0 = 3
    ranks = list(object.ranks)
    if rmax is None:
        rmax = ranks[-1]
    rmax = int(rmax)
    if (r0 - 1) not in ranks:
        raise ValueError("build_tree requires rank 2 in the scan")
    i0 = ranks.index(r0 - 1)
    i1 = ranks.index(rmax)

    cluster = {}
    for i in range(i0, i1 + 1):
        h = object.coeff[i]
        cluster[f"r{ranks[i]}"] = np.argmax(h, axis=0) + 1  # 1-based

    tree = ["2.1", "2.2"]
    for nrk in range(r0, rmax + 1):
        x0 = cluster[f"r{nrk - 1}"]
        x1 = cluster[f"r{nrk}"]
        # contingency table with fixed levels 1..n-1 x 1..n
        tab = np.zeros((nrk - 1, nrk), dtype=np.int64)
        for a, b in zip(x0, x1):
            tab[a - 1, b - 1] += 1
        z = np.argmax(tab, axis=0) + 1  # parent of each child; ties->first

        parents, counts = np.unique(z, return_counts=True)
        split_parents = parents[counts > 1]
        for w in split_parents:
            kids = [f"{nrk}.{c + 1}" for c in range(nrk) if z[c] == w]
            tree = branch_tree(tree, f"{nrk - 1}.{w}", kids)
        single_parents = parents[counts == 1]
        old = [f"{nrk - 1}.{w}" for w in single_parents]
        new = [f"{nrk}.{int(np.nonzero(z == w)[0][0]) + 1}"
               for w in single_parents]
        tree = update_tree(tree, old, new)
    return tree


def rename_tips(tree, rank: int, tip_labels):
    """Rename tips of a given rank with cell-type labels
    (reference R/tree.R:144-156)."""
    out = []
    for node in tree:
        if isinstance(node, str):
            rk, cid = node.split(".", 1)
            if int(rk) == rank:
                out.append(f"{rank}.{tip_labels[int(cid) - 1]}")
            else:
                out.append(node)
        else:
            name, children = node
            out.append((name, rename_tips(children, rank, tip_labels)))
    return out


# ---------------------------------------------------------------------
# Dendrogram plotting (matplotlib; reference uses ape::plot.phylo)
# ---------------------------------------------------------------------

def _layout(tree, parent_rank, x0, next_y, segments, labels):
    """Recursive rectangular-dendrogram layout.  Returns y of subtree."""
    ys = []
    for node in tree:
        if isinstance(node, str):
            rk = _rank_of(node)
            y = next_y[0]
            next_y[0] += 1.0
            segments.append(((x0, y), (rk, y)))
            labels.append((rk, y, node))
            ys.append(y)
        else:
            name, children = node
            rk = _rank_of(name)
            y = _layout(children, rk, rk, next_y, segments, labels)
            segments.append(((x0, y), (rk, y)))
            labels.append((rk, y, name))
            ys.append(y)
    ymid = float(np.mean(ys))
    # vertical connector at x0
    segments.append(((x0, min(ys)), (x0, max(ys))))
    return ymid


def plot_tree(tree, direction: str = "rightwards", cex: float = 8.0,
              ax=None):
    """Plot the cluster tree as a dendrogram (reference R/tree.R:179)."""
    import matplotlib.pyplot as plt

    segments, labels = [], []
    next_y = [0.0]
    _layout(tree, 1, 2, next_y, segments, labels)
    if ax is None:
        _, ax = plt.subplots()
    for (xa, ya), (xb, yb) in segments:
        if direction == "downwards":
            ax.plot([ya, yb], [-xa, -xb], "k-", lw=1)
        else:
            ax.plot([xa, xb], [ya, yb], "k-", lw=1)
    for x, y, text in labels:
        if direction == "downwards":
            ax.text(y, -x - 0.05, text, fontsize=cex, ha="center",
                    va="top")
        else:
            ax.text(x + 0.05, y, text, fontsize=cex, va="center")
    ax.set_axis_off()
    return ax
