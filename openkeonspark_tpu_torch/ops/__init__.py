"""Hand-written CUDA kernels (``csrc/``, built by ``build.py``) and their
plain PyTorch versions (``rank.py``, ``grouped.py``, ``scatter.py``,
``merge.py``)."""
