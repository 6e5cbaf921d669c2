"""paddle.utils.download in the port (``paddle_tpu/utils/download.py``).

The port has no network: ``get_weights_path_from_url`` resolves a file
already in the weights home (``PADDLE_TPU_WEIGHTS_HOME``, by default
``~/.cache/paddle_tpu/weights``), checks its md5 when given one, and
otherwise raises instead of fetching.
"""
from __future__ import annotations

import hashlib
import os

from ..errors import PreconditionNotMetError, UnavailableError

__all__ = ["get_weights_path_from_url"]


def _weights_home() -> str:
    # read at each call: the error tells the user to set the variable and
    # retry, which must work within the same process
    return os.path.expanduser(os.environ.get("PADDLE_TPU_WEIGHTS_HOME",
                                             "~/.cache/paddle_tpu/weights"))


def get_weights_path_from_url(url: str, md5sum=None) -> str:
    """The path of ``url``'s file in the weights home; raises
    ``PreconditionNotMetError`` when its md5 is not ``md5sum`` and
    ``UnavailableError`` when the file is not there."""
    home = _weights_home()
    path = os.path.join(home, url.split("/")[-1].split("?")[0])
    if os.path.exists(path):
        if md5sum is not None:
            with open(path, "rb") as f:
                got = hashlib.md5(f.read()).hexdigest()
            if got != md5sum:
                raise PreconditionNotMetError(
                    f"{path} exists but its md5 {got} != expected {md5sum} "
                    "(corrupt or truncated copy?)")
        return path
    raise UnavailableError(
        f"cannot download {url!r}: this runtime has no network egress. Place the file at "
        f"{path} (WEIGHTS_HOME={home}, override with PADDLE_TPU_WEIGHTS_HOME) and retry.")
