"""Text datasets (paddle.text.datasets surface; ``paddle_tpu/text``, host code copied for the port).

Reference parity: python/paddle/dataset/{imdb.py, imikolov.py, wmt14.py,
wmt16.py, conll05.py, movielens.py} reader creators and the 2.x
map-style wrappers (incubate/hapi/text + paddle/text/datasets/).

Offline discipline (same as vision/datasets.py): zero network egress, so
each dataset loads the reference's cached on-disk format when present
under ``PADDLE_TPU_DATA_HOME`` and otherwise synthesizes a deterministic
corpus with the SAME shapes/vocab structure — and, crucially, with
LEARNABLE signal (sentiment words correlate with labels, translations
are a deterministic token mapping) so book tests can train to a
decreasing loss rather than fit noise. Every instance sets
``self.synthetic`` so tests can tell real data from stand-in data.
"""
from .datasets import (  # noqa: F401
    Conll05st,
    Imdb,
    Imikolov,
    Movielens,
    MQ2007,
    Sentiment,
    UCIHousing,
    WMT14,
    WMT16,
)

__all__ = [
    "Imdb", "Imikolov", "Movielens", "WMT14", "WMT16", "Conll05st",
    "UCIHousing", "Sentiment", "MQ2007",
]
