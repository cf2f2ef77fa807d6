"""search_rows_per_s.mixed: ``search_rows_per_s``'s arithmetic in a cell
where inserts run beside the searches.  There its runs swing too widely
to bound (the two lanes share the host's interpreter lock and the state
lock), so it is read here, beside the lanes, and bounded only in the
search-only cell."""

from bench import readers


def read(ctx):
    return readers.search_rows_per_s(ctx)
