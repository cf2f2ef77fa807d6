"""insert_rows_per_s: insert rows acknowledged in the window over its
length (``bench/readers.py::insert_rows_per_s``).  The stream is open
loop and sends the same number of inserts in every window
(``schedule.arrivals``), so this reads the offered rate
while the mutation lane keeps up, and falls as far as it falls behind."""

from bench import readers


def read(ctx):
    return readers.insert_rows_per_s(ctx)
