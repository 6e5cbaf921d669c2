"""The high-level API in the port (``paddle_tpu/hapi``): ``Model``, ``summary``
and the training callbacks.

Reference parity: python/paddle/incubate/hapi/ — model.py (Model :637,
fit :1110, evaluate :1309, predict :1406), callbacks.py, progressbar.
"""
from .model import Model, summary  # noqa: F401
from .callbacks import Callback, EarlyStopping, ModelCheckpoint, ProgBarLogger  # noqa: F401
