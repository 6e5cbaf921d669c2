"""Inference of the port."""
from .predictor import Config, Predictor, ProgramPredictor, create_predictor  # noqa: F401
