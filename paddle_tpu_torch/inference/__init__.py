"""Inference of the port: the predictors and Paddle's handle API
(``AnalysisConfig``, ``PredictorTensor``)."""
from .predictor import (  # noqa: F401
    Config,
    Predictor,
    PredictorTensor,
    ProgramPredictor,
    create_predictor,
)

AnalysisConfig = Config
