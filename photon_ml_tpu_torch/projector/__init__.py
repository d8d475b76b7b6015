"""Port of photon_ml_tpu/projector/ (see projectors.py)."""
