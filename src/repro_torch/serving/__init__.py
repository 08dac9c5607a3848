"""Serving layer of the port: micro-batching and the hybrid search service."""
