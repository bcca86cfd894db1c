"""Metagene extraction and cluster visualization.

Equivalents of reference meta_genes/gene_select (R/utils.R:605-660),
meta_gene.cv / write_meta (R/utils2.R:16-29,136-178), gene_map /
feature_map / cell_map (R/utils.R:396-579) and visualize_clusters
(R/utils.R:692-712).  Heatmaps/t-SNE render via matplotlib/sklearn.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from .container import SCSet


def _standardize_w(w, subtract_mean=True, log=True):
    """Row-standardize W: geometric (log) or arithmetic de-meaning
    (reference R/utils.R:611-616)."""
    w = np.asarray(w, dtype=float)
    if subtract_mean:
        if log:
            w = np.log10(w)
        w = w - w.mean(axis=1, keepdims=True)
        if log:
            w = 10.0 ** w
    return w


def _gene_names(obj, w, gene_names):
    if gene_names is not None:
        return np.asarray(gene_names, dtype="object")
    if obj is not None:
        return np.asarray(obj.rownames, dtype="object")
    return np.arange(w.shape[0]).astype("object")


def meta_genes(object=None, rank=None, basis_matrix=None,
               max_per_cluster=10, gene_names=None, subtract_mean=True,
               log=True):
    """Metagenes per cluster by the "max scheme"
    (reference R/utils.R:605-641): for cluster k, genes sorted by
    W[:,k] descending whose row-argmax is k, capped at
    ``max_per_cluster``.  Returns a list of name-arrays.
    """
    if basis_matrix is None:
        w = _standardize_w(object.basis_at(rank), subtract_mean, log)
    else:
        w = np.asarray(basis_matrix, dtype=float)
        rank = w.shape[1]
    names = _gene_names(object if basis_matrix is None else None,
                        w, gene_names)
    nmax = min(max_per_cluster, w.shape[0])
    amax = np.argmax(w, axis=1)
    select = []
    for k in range(rank):
        order = np.argsort(-w[:, k], kind="stable")
        rows = order[amax[order] == k][:nmax]
        select.append(names[rows])
    return select


def gene_select(w, names, markers=None, max_per_cluster=10):
    """Gene list for heatmap display (reference R/utils.R:643-660)."""
    rank = w.shape[1]
    names = np.asarray(names, dtype="object")
    out = []
    keep = np.ones(len(names), dtype=bool)
    if markers is not None:
        markers = [mk for mk in markers if mk in set(names)]
        out.extend(markers)
        keep = ~np.isin(names, markers)
    w = w[keep]
    names = names[keep]
    amax = np.argmax(w, axis=1)
    nmax = min(max_per_cluster, w.shape[0])
    for k in range(rank):
        order = np.argsort(-w[:, k], kind="stable")
        rows = order[amax[order] == k][:nmax]
        out.extend(names[rows])
    return out


def meta_gene_cv(object=None, rank=None, basis_matrix=None, dbasis=None,
                 max_per_cluster=100, gene_names=None,
                 subtract_mean=True, log=True, cv_max=np.inf):
    """Metagene table with coefficient of variation
    (reference R/utils2.R:136-178): per cluster k, top genes by
    standardized W[:,k] with columns Gene_k, W_k, CV_k where
    CV = dbasis / W (computed on the raw W)."""
    if basis_matrix is None:
        w_raw = object.basis_at(rank)
        cw = object.dbasis_at(rank) / w_raw
        w = _standardize_w(w_raw, subtract_mean, log)
    else:
        w = np.asarray(basis_matrix, dtype=float)
        rank = w.shape[1]
        cw = np.asarray(dbasis, dtype=float) / w
    names = _gene_names(object if basis_matrix is None else None,
                        w, gene_names)
    nmax = min(max_per_cluster, w.shape[0])

    cols = {}
    maxrow = 0
    for k in range(rank):
        idx = np.argsort(-w[:, k], kind="stable")[:nmax]
        sig = np.nonzero(cw[idx, k] <= cv_max)[0]
        g = np.full(nmax, "", dtype="object")
        wv = np.full(nmax, np.nan)
        cv = np.full(nmax, np.nan)
        g[:len(sig)] = names[idx[sig]]
        wv[:len(sig)] = w[idx[sig], k]
        cv[:len(sig)] = cw[idx[sig], k]
        maxrow = max(maxrow, len(sig))
        cols[f"Gene_{k + 1}"] = g
        cols[f"W_{k + 1}"] = wv
        cols[f"CV_{k + 1}"] = cv
    dat = pd.DataFrame(cols)
    return dat.iloc[:maxrow]


def write_meta(meta, file):
    """Write metagene lists as csv (reference R/utils2.R:16-29)."""
    rank = len(meta)
    nmax = max((len(mk) for mk in meta), default=0)
    dat = np.full((nmax, rank), "", dtype="object")
    for k, mk in enumerate(meta):
        dat[:len(mk), k] = np.asarray(mk, dtype="object")
    df = pd.DataFrame(dat, columns=[str(k + 1) for k in range(rank)],
                      index=[str(i + 1) for i in range(nmax)])
    df.to_csv(file)
    return meta


# ---------------------------------------------------------------------
# Heatmaps (matplotlib equivalents of stats::heatmap / image plots)
# ---------------------------------------------------------------------

def _cluster_colors(n):
    import matplotlib.cm as cm
    return [cm.hsv(i / max(n, 1)) for i in range(n)]


def gene_map(object: SCSet, rank=None, markers=None, subtract_mean=True,
             log=True, max_per_cluster=10, gene_names=None,
             main="Genes", ax=None, row_cluster=False):
    """Heatmap of metagene basis-matrix magnitudes
    (reference R/utils.R:396-418).

    ``row_cluster=True`` reproduces the reference's row layout: it
    renders W through ``stats::heatmap(w, RowSideColors=..,
    revC=TRUE)`` (R/utils.R:416-418), which orders rows by a
    hierarchical dendrogram.  Here: scipy complete-linkage on
    euclidean distances (stats::heatmap's defaults) with optimal leaf
    ordering, rows displayed bottom-up (the ``revC=TRUE`` visual),
    and the dendrogram drawn in a side panel.  The default
    (``False``) keeps the argmax-cluster block ordering, which groups
    metagenes contiguously.
    """
    import matplotlib.pyplot as plt

    if rank is None:
        rank = object.ranks[0]
    w = _standardize_w(object.basis_at(rank), subtract_mean, log)
    names = _gene_names(object, w, gene_names)
    if w.shape[0] > max_per_cluster:
        sel_names = gene_select(w, names, markers, max_per_cluster)
        pos = {nm: i for i, nm in enumerate(names)}
        rows = [pos[nm] for nm in sel_names]
    else:
        rows = list(range(w.shape[0]))
    wsel = w[rows]
    nm = names[rows]
    gid = np.argmax(wsel, axis=1)

    dax = None
    if row_cluster and len(nm) > 2:
        from scipy.cluster import hierarchy

        lk = hierarchy.optimal_leaf_ordering(
            hierarchy.linkage(wsel, method="complete"), wsel)
        order = hierarchy.leaves_list(lk)[::-1]     # revC=TRUE
        if ax is None:
            _, (dax, ax) = plt.subplots(
                1, 2, figsize=(7.5, max(4, 0.25 * len(nm))),
                width_ratios=[1, 4], sharey=False)
            with plt.rc_context({"lines.linewidth": 0.8}):
                hierarchy.dendrogram(
                    lk, ax=dax, orientation="left", no_labels=True,
                    color_threshold=0, above_threshold_color="0.3")
            dax.set_axis_off()
    else:
        order = np.argsort(gid, kind="stable")
    wsel, nm, gid = wsel[order], nm[order], gid[order]

    if ax is None:
        _, ax = plt.subplots(figsize=(6, max(4, 0.25 * len(nm))))
    ax.imshow(wsel, aspect="auto", cmap="YlOrRd")
    ax.set_yticks(range(len(nm)))
    ax.set_yticklabels(nm, fontsize=7)
    ax.set_xticks(range(rank))
    ax.set_xticklabels(range(1, rank + 1))
    ax.set_title(main)
    colors = _cluster_colors(rank)
    for i, g in enumerate(gid):
        ax.plot(-0.6, i, "s", color=colors[g], clip_on=False, ms=5)
    return ax


def feature_map(object: SCSet = None, basis_matrix=None, rank=None,
                markers=None, subtract_mean=True, log=True,
                max_per_cluster=10, feature_names=None, perm=None,
                main="Feature map", ax=None):
    """Flexible basis-matrix heatmap with metagene blocks and optional
    extra markers (reference R/utils.R:467-541)."""
    import matplotlib.pyplot as plt

    if rank is None:
        rank = (basis_matrix.shape[1] if basis_matrix is not None
                else object.ranks[0])
    if perm is None:
        perm = list(range(rank))
    else:
        perm = [p - 1 if min(perm) >= 1 else p for p in perm]

    if basis_matrix is None:
        w = object.basis_at(rank)[:, perm]
        meta = meta_genes(object, rank=rank, subtract_mean=subtract_mean,
                          gene_names=feature_names, log=log,
                          max_per_cluster=max_per_cluster)
    else:
        w = np.asarray(basis_matrix, dtype=float)
        meta = meta_genes(basis_matrix=w, rank=rank,
                          gene_names=feature_names,
                          max_per_cluster=max_per_cluster)
    names = _gene_names(object if basis_matrix is None else None, w,
                        feature_names)
    if log:
        w = w / np.exp(np.mean(np.log(w), axis=1, keepdims=True))
    else:
        w = w - w.mean(axis=1, keepdims=True)

    meta = [meta[p] for p in perm]
    pos = {nm: i for i, nm in enumerate(names)}
    extra = []
    if markers is not None:
        inmeta = set(np.concatenate(meta)) if meta else set()
        extra = [mk for mk in markers if mk in pos and mk not in inmeta]
    gid = {mk: int(np.argmax(w[pos[mk]])) for mk in extra}

    idx, step = [], []
    for k in range(rank):
        block = list(meta[k]) + [mk for mk in extra if gid[mk] == k]
        step.append(len(block))
        idx.extend(block)
    rows = [pos[nm] for nm in idx]
    w1 = w[rows]
    x = w1 - w1.mean(axis=1, keepdims=True)
    sd = x.std(axis=1, ddof=1, keepdims=True)
    x = np.divide(x, sd, out=np.zeros_like(x), where=sd > 0)

    if ax is None:
        _, ax = plt.subplots(figsize=(6, max(4, 0.22 * len(idx))))
    ax.imshow(x, aspect="auto", cmap="YlOrRd")
    ax.set_yticks(range(len(idx)))
    ax.set_yticklabels(idx, fontsize=7)
    ax.set_xticks(range(rank))
    ax.set_xticklabels(range(1, rank + 1))
    y = -0.5
    for k in range(rank):
        ax.axhline(y, color="k", lw=0.5, ls="--")
        y += step[k]
    ax.set_title(main)
    return ax


def cell_map(object: SCSet, rank=None, main="Cells", ax=None):
    """Heatmap of the coefficient matrix H with cluster color bars
    (reference R/utils.R:568-579)."""
    import matplotlib.pyplot as plt

    if rank is None:
        rank = object.ranks[0]
    h = object.coeff_at(rank)
    cid = np.argmax(h, axis=0)
    order = np.argsort(cid, kind="stable")
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 3))
    ax.imshow(h[:, order], aspect="auto", cmap="YlOrRd")
    ax.set_ylabel("cluster")
    ax.set_yticks(range(h.shape[0]))
    ax.set_yticklabels(range(1, h.shape[0] + 1))
    ax.set_title(main)
    colors = _cluster_colors(h.shape[0])
    for j, c in enumerate(cid[order]):
        ax.plot(j, -0.7, "s", color=colors[c], ms=2, clip_on=False)
    return ax


def visualize_clusters(object: SCSet, rank=None, verbose=False, cex=16.0,
                       axes=None, seed=0, max_cells=20000, **tsne_kw):
    """t-SNE map of cells colored by hard cluster + cluster-size barplot
    (reference R/utils.R:692-712).

    ``max_cells`` bounds the t-SNE input at atlas scale (sklearn's
    Barnes-Hut t-SNE is O(m log m) with a large constant — 100k cells
    take tens of minutes): beyond it, a seed-deterministic uniform
    subsample feeds the embedding while the cluster-size barplot keeps
    ALL cells.  ``None`` disables the bound (the reference embeds
    everything, R/utils.R:700).
    """
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    if rank is None:
        rank = object.ranks[0]
    h = object.coeff_at(rank)
    m = h.shape[1]
    cid_all = np.argmax(h, axis=0)
    if max_cells is not None and m > max_cells:
        sel = np.random.default_rng(seed).choice(m, max_cells,
                                                 replace=False)
        sel.sort()
        h_emb = h[:, sel]
        cid = cid_all[sel]
    else:
        h_emb = h
        cid = cid_all
    m_emb = h_emb.shape[1]
    perplexity = tsne_kw.pop("perplexity",
                             min(30.0, max(2.0, m_emb / 4 - 1)))
    ts = TSNE(n_components=2, perplexity=perplexity, random_state=seed,
              init="pca", verbose=int(verbose), **tsne_kw)
    y = ts.fit_transform(h_emb.T)
    colors = _cluster_colors(h.shape[0])

    if axes is None:
        _, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].scatter(y[:, 0], y[:, 1], s=cex,
                    c=[colors[c] for c in cid], edgecolors="k", lw=0.3)
    axes[0].set_xlabel("tSNE1")
    axes[0].set_ylabel("tSNE2")
    axes[0].set_title("Clusters")
    ids, cnt = np.unique(cid_all, return_counts=True)
    axes[1].bar([str(i + 1) for i in ids], cnt,
                color=[colors[i] for i in ids])
    axes[1].set_yscale("log")
    axes[1].set_title("Cell counts")
    return axes
