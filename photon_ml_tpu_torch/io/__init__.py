"""Port of photon_ml_tpu/io/: the Avro container codec, the schemas and
model persistence (see each module's docstring)."""
