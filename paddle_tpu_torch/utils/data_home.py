"""The dataset home and the synthetic-data notice (``paddle_tpu/utils/data_home.py``), used by
the port's ``vision.datasets`` and ``text.datasets``."""
from __future__ import annotations

import os

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset")
)


def warn_synthetic(ds, fallback=True):
    """Loud, once-per-instance notice that a dataset produced
    deterministic synthetic samples; pairs with the ``ds.synthetic``
    attribute tests check. ``fallback=False`` marks datasets that have no
    real-data loader at all (offline-only corpora), so the message does
    not send users chasing files that would never be read."""
    import warnings

    if fallback:
        msg = (
            f"{type(ds).__name__}: real data files not found under "
            f"{DATA_HOME!r}; generating deterministic SYNTHETIC samples "
            "(self.synthetic=True). Place the reference-format files "
            "there for real-data runs."
        )
    else:
        msg = (
            f"{type(ds).__name__}: this corpus is synthesized offline by "
            "design (no real-data loader in this environment); samples "
            "are deterministic SYNTHETIC data (self.synthetic=True)."
        )
    warnings.warn(msg, RuntimeWarning, stacklevel=3)
