"""Runtime for the port (``repro/runtime``): fault tolerance."""
