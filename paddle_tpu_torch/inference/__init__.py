"""Inference of the port."""
from .predictor import Predictor  # noqa: F401
