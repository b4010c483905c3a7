"""The plain reference the benchmark holds the program to: NumPy and
plain PyTorch, importing nothing of the program. ``sgns`` is the
sequential SGNS update, ``batching`` a frozen copy of the host batching
rules (subsampling, packing, negative draws) and ``init`` the table
initialisation rule."""
