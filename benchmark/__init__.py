"""The benchmark of ``instag_torch`` on an NVIDIA H100: ``run.py`` runs one
cell of the repository's ``BENCHMARK.json``; see ``README.md``."""
