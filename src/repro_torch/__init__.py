"""repro_torch: the JSPIM engine ported to PyTorch and CUDA for one H100.

A second package beside the JAX reference ``repro``, with the same layers:
core (dictionary, hash dataset, probe) -> kernels (hand-written CUDA for
sm_90a, with plain PyTorch versions) -> engine (column store, SSB, epoch
snapshots) -> serving (batched parameterized requests over snapshots),
and the model zoo with its LM serving and training paths (models,
configs, serve, optim, train, data).
It imports neither JAX nor ``repro``.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
