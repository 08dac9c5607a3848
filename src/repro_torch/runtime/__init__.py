"""Runtime for the port (``repro/runtime``): fault tolerance and build
dispatch accounting."""
