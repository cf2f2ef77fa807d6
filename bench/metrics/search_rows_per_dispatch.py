"""search_rows_per_dispatch: see ``bench/readers.py::search_rows_per_dispatch``."""

from bench import readers


def read(ctx):
    return readers.search_rows_per_dispatch(ctx)
