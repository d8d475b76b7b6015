"""Math and storage constants (a copy of photon_ml_tpu/constants.py;
reference: ml/constants/MathConst.scala)."""

HIGH_PRECISION_TOLERANCE = 1e-12
MEDIUM_PRECISION_TOLERANCE = 1e-8
LOW_PRECISION_TOLERANCE = 1e-4
EPSILON = 1e-15

# Classification: scores >= threshold are positive (reference MathConst
# POSITIVE_RESPONSE_THRESHOLD = 0.5).
POSITIVE_RESPONSE_THRESHOLD = 0.5
