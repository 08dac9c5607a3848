"""Graph nodes the beam search expanded per query (over every segment
searched), mean over the window."""


def read(record):
    v = record.values.get("search.expanded_per_query")
    return sum(v) / len(v) if v else None
