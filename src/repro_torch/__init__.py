"""PyTorch/CUDA port of the Allan-Poe hybrid index (held against ``repro``).

The package mirrors ``repro``'s module layout: ``repro_torch/core/search.py``
is held against ``repro/core/search.py`` and so on. It imports ``torch`` and
numpy only. Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""
