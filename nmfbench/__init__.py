"""The benchmark of ``ccfindr_tpu_torch``: VB rank scans on planted
single-cell count matrices, driven through the public entry.

One command runs one cell once::

    python3 -m nmfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer
metric, dataset kind or entry sits in a file of its own under this
folder and is found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``   the deployment: shape, counts, source;
* ``traffic/<mix>.json``      what the analyst runs: entry, backend,
                              ranks, nrun, Itmax, Tol, answers checked;
* ``limits/<workload>.json``  each compared number's limit and the
                              readings it was set from;
* ``metrics/<metric>.py``     one reader a metric (``read(run)``);
* ``datasets/<kind>.py``      one generator a kind of counts;
* ``entries/<entry>.py``      one driver call and its check an entry.

Nothing here imports JAX or the JAX package, and the reference
(``reference.py``) imports nothing of the port.
"""
