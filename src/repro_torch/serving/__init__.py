"""Serving layer of the port: micro-batching, the hybrid search service,
the grow-segment router and the replica tier."""
