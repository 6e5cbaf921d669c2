"""The local file system of auto-checkpoint (``paddle_tpu/incubate/fs_local.py``).

The JAX package takes ``LocalFS`` from ``distributed/fleet/utils/fs.py``;
the port has no fleet yet (ROADMAP.md Queue A item 9), so it keeps its own
copy of the methods auto-checkpoint calls.
"""
from __future__ import annotations

import os
import shutil

__all__ = ["LocalFS", "local_fs"]


class LocalFS:
    """fleet/utils/fs.py LocalFS: local-disk operations."""

    def ls_dir(self, path):
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for entry in sorted(os.listdir(path)):
            full = os.path.join(path, entry)
            (dirs if os.path.isdir(full) else files).append(entry)
        return dirs, files

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_file(self, path):
        return os.path.isfile(path)

    def is_exist(self, path):
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src, dst):
        os.replace(src, dst)

    mv = rename

    def touch(self, path):
        with open(path, "a"):
            os.utime(path, None)


def local_fs():
    return LocalFS()
