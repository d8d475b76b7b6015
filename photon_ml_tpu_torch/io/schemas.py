"""Avro schemas matching the reference's layout so data/models interoperate
(a copy of photon_ml_tpu/io/schemas.py:1-88).

Reference: photon-avro-schemas/src/main/avro/ — TrainingExampleAvro.avsc,
NameTermValueAvro.avsc, BayesianLinearModelAvro.avsc, LatentFactorAvro.avsc,
ScoringResultAvro.avsc, FeatureSummarizationResultAvro.avsc. Field names and
shapes are reproduced (schemas re-written, not copied) so files written by
the reference's pipelines parse here and vice versa.
"""

NAME_TERM_VALUE = {
    "type": "record",
    "name": "NameTermValueAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": ["null", "string"], "default": None},
        {"name": "value", "type": "double"},
    ],
}

TRAINING_EXAMPLE = {
    "type": "record",
    "name": "TrainingExampleAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array",
                                      "items": NAME_TERM_VALUE}},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
        {"name": "metadataMap",
         "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
    ],
}

BAYESIAN_LINEAR_MODEL = {
    "type": "record",
    "name": "BayesianLinearModelAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
        {"name": "means", "type": {"type": "array",
                                   "items": NAME_TERM_VALUE}},
        {"name": "variances",
         "type": ["null", {"type": "array", "items": NAME_TERM_VALUE}],
         "default": None},
    ],
}

LATENT_FACTOR = {
    "type": "record",
    "name": "LatentFactorAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "effectId", "type": "string"},
        {"name": "latentFactor", "type": {"type": "array",
                                          "items": "double"}},
    ],
}

SCORING_RESULT = {
    "type": "record",
    "name": "ScoringResultAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "predictionScore", "type": "double"},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "metadataMap",
         "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
    ],
}

FEATURE_SUMMARIZATION_RESULT = {
    "type": "record",
    "name": "FeatureSummarizationResultAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "featureName", "type": "string"},
        {"name": "featureTerm", "type": ["null", "string"], "default": None},
        {"name": "metrics", "type": {"type": "map", "values": "double"}},
    ],
}
