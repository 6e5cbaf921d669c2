"""Incubating APIs of the port (``paddle_tpu/incubate``): ``auto_checkpoint``,
the hapi text layers (``hapi_text``), the program statistics of
``model_stat`` and the 2.x optimizer-wrapper names."""
from . import auto_checkpoint  # noqa: F401
from . import hapi_text  # noqa: F401
from ..optimizer.wrappers import Lookahead, ModelAverage  # noqa: F401
from .model_stat import memory_usage, op_freq_statistic  # noqa: F401

LookAhead = Lookahead
