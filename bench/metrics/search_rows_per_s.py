"""search_rows_per_s: see ``bench/readers.py::search_rows_per_s``."""

from bench import readers


def read(ctx):
    return readers.search_rows_per_s(ctx)
