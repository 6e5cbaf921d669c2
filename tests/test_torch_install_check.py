"""``utils.run_check`` and ``utils.download`` in the port against the JAX
package's (``paddle_tpu/utils``): ``run_check`` trains the 8-16-2 net through
a compiled train step and says so (on the CPU here; on the card
``chip_smoke.py`` phase 12u runs it captured), its sharded branch runs in a
world of two gloo ranks, and without a card it refuses to pick the CPU on
its own. The download gate resolves only files already in the weights
home, checks their md5 and raises the JAX package's errors."""
import hashlib

import pytest
import torch

from paddle_tpu import utils as jax_utils
from paddle_tpu_torch import errors, utils

import _torch_dist as td


def test_run_check_on_the_cpu(capsys):
    utils.run_check(device="cpu")
    out = capsys.readouterr().out
    assert "paddle_tpu_torch 0.1.0" in out and "1 cpu device visible, 1 in the world" in out
    assert "single-device compiled train step: OK" in out
    assert "installed successfully" in out
    assert "sharded" not in out  # one device: no sharded branch


def test_run_check_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        utils.run_check()


def test_run_check_runs_the_sharded_branch_in_a_world_of_two(tmp_path):
    rows = td.run_world(2, "run_check", str(tmp_path))
    assert [r["rank"] for r in rows] == [0, 1]
    for r in rows:
        lines = r["run_check"]
        assert "2 in the world" in lines[0]
        assert "2-device sharded train step: OK (matches single-device loss)" in lines
        assert lines[-1] == "paddle_tpu_torch is installed successfully!"


def test_the_exports_are_the_jax_packages():
    assert callable(utils.run_check) and callable(jax_utils.run_check)
    assert utils.download.get_weights_path_from_url.__name__ == \
        jax_utils.download.get_weights_path_from_url.__name__


def test_download_gated(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_WEIGHTS_HOME", str(tmp_path))
    url = "http://x/y/model.pdparams?sig=1"
    with pytest.raises(errors.UnavailableError, match="no network egress") as mine:
        utils.download.get_weights_path_from_url(url)
    from paddle_tpu.errors import UnavailableError

    with pytest.raises(UnavailableError) as theirs:
        jax_utils.download.get_weights_path_from_url(url)
    assert str(mine.value) == str(theirs.value)
    (tmp_path / "model.pdparams").write_bytes(b"x")
    p = utils.download.get_weights_path_from_url(url)
    assert p == str(tmp_path / "model.pdparams")
    assert p == jax_utils.download.get_weights_path_from_url(url)


def test_download_md5_verification(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_WEIGHTS_HOME", str(tmp_path))
    (tmp_path / "w.bin").write_bytes(b"good")
    ok = hashlib.md5(b"good").hexdigest()
    assert utils.download.get_weights_path_from_url("http://x/w.bin", md5sum=ok)
    with pytest.raises(errors.PreconditionNotMetError, match="md5"):
        utils.download.get_weights_path_from_url("http://x/w.bin", md5sum="0" * 32)
