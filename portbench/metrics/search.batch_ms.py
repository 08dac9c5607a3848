"""Milliseconds of one synchronised search call over the whole query set,
by the host clock, mean over the window's untraced calls."""


def read(record):
    ms = record.values.get("search.batch_ms")
    return sum(ms) / len(ms) if ms else None
