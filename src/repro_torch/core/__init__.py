"""Allan-Poe core in PyTorch: the all-in-one hybrid graph index."""
