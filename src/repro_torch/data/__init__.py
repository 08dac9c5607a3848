"""Synthetic data for the port (structure of ``repro.data``)."""
