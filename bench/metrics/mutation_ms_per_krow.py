"""mutation_ms_per_krow: see ``bench/readers.py::mutation_ms_per_krow``."""

from bench import readers


def read(ctx):
    return readers.mutation_ms_per_krow(ctx)
