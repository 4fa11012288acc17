"""Traffic modules, one a kind (``train``, ``linkpred``,
``topk``), and the mixes that name them (``<mix>.json``)."""
