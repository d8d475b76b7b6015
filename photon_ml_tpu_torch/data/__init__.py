"""Data structures and host-side ingest (port of photon_ml_tpu/data/; see
each module's docstring). As in the JAX package, the package itself
imports nothing, so the ingest workers (``python -m
photon_ml_tpu_torch.data.parallel_ingest``) import its modules without
torch."""
