"""The benchmark of millieye_torch: ``python3 -m perfbench.run`` runs one
cell of ``BENCHMARK.json`` once (see ``run.py``)."""
