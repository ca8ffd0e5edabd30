"""Twins of the JAX package's ``examples/`` on the port: each keeps its
example's structure, traffic and printed lines, returns its results from a
function (for the tests and ``chip_smoke.py``), and runs on the CUDA card
unless ``--device cpu`` is given (``python -m repro_torch.examples.<name>``).
``quickstart`` imports only the scheduler, so it is a copy."""
