"""The LM stack of the port (``repro/models``): the dense transformer family
behind retrieval-augmented generation."""
