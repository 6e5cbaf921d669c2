"""Port parity: train-step checkpoints in the JAX package's layout (``paddle_tpu/distributed/checkpoint.py``).

- A tiny BERT pretraining step under Lamb: the JAX ``TrainStepFn`` trains
  2 steps and saves; the port's step loads the snapshot (every leaf
  bit-equal to the saved one, the step counts reset from it) and its next
  loss equals the JAX step's 3rd within :data:`LOSS_RTOL` (one f32
  forward in another summation order). The reverse: the port trains and
  saves, the JAX step loads and continues, the same way.
- The port saving the state it loaded writes the JAX files byte for byte
  (the shard and the commit record; the manifest apart from its time).
- A flipped byte raises ``CheckpointCorruptError``; ``latest_checkpoint``
  skips a torn (manifest-less) and a corrupt snapshot; ``sweep_tmp``
  removes torn ``.tmp`` directories; ``keep`` rotation; the async writer
  publishes in order and surfaces a failure in ``wait_pending``; a missing
  or extra leaf or a wrong shape raises ``CheckpointError``; a load copies
  into the live tensors (their storage stays).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jax_opt  # noqa: E402
from paddle_tpu.distributed import checkpoint as jckpt  # noqa: E402
from paddle_tpu.framework import jit as jax_jit  # noqa: E402
from paddle_tpu.models import BertForPretraining as JaxBertForPretraining  # noqa: E402
from paddle_tpu.models import BertPretrainingCriterion as JaxCriterion  # noqa: E402
from paddle_tpu.models import bert_tiny_config as jax_tiny_config  # noqa: E402

from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.distributed import checkpoint as ckpt  # noqa: E402
from paddle_tpu_torch.framework.jit import train_step  # noqa: E402
from paddle_tpu_torch.models import BertForPretraining, BertPretrainingCriterion  # noqa: E402
from paddle_tpu_torch.models import bert_tiny_config  # noqa: E402

torch.set_num_threads(1)

# the next loss after a load, against the other package's: one f32
# forward through 2 layers in another summation order
LOSS_RTOL = 1e-5
B, L, P = 2, 16, 3


def _config(cls):
    cfg = cls()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _batch(cfg, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, cfg.vocab_size, (B, L)).astype("int64")
    types = (np.arange(L)[None, :] >= L // 2).astype("int64").repeat(B, 0)
    pos = np.stack([rng.choice(L, P, replace=False) + i * L for i in range(B)]).ravel()
    mlm = rng.randint(0, cfg.vocab_size, (B * P,)).astype("int64")
    nsp = rng.randint(0, 2, (B, 1)).astype("int64")
    return [ids, types, pos.astype("int64"), mlm, nsp]


def _loss_fn(crit):
    def loss_fn(m, ids, types, pos, mlm, nsp):
        pred, rel = m(ids, types, masked_positions=pos)
        return crit(pred, rel, mlm, nsp)
    return loss_fn


def _lamb(mod, params):
    # 1-D parameters (biases, LayerNorm) excluded from the decay: the same
    # choice in both packages, whatever names they give
    return mod.Lamb(learning_rate=1e-2, lamb_weight_decay=0.01, parameters=params,
                    exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1)


def _jax_step(seed=0):
    paddle.seed(seed)
    jm = JaxBertForPretraining(_config(jax_tiny_config))
    return jm, jax_jit.train_step(jm, _lamb(jax_opt, jm.parameters()),
                                  _loss_fn(JaxCriterion(jm.bert.config.vocab_size)))


def _port_step(jm):
    """The port's step over a model holding ``jm``'s weights."""
    tm = BertForPretraining(_config(bert_tiny_config))
    np_state = {n: np.asarray(p._array) for n, p in jm.named_parameters()}
    tm.load_state_dict(convert.bert_pretraining_state_from_numpy(np_state, tm))
    crit = BertPretrainingCriterion(tm.bert.config.vocab_size)
    return train_step(tm, _lamb(port_opt, tm.parameters()), _loss_fn(crit), jit=True,
                      device="cpu")


def _port_leaves(step):
    return {n: t.detach().numpy().copy() if t.dim() or t.dtype != torch.int32
            else np.asarray(t.numpy()) for n, t in step.state_leaves()}


def test_leaf_names_are_the_jax_steps():
    with jax.enable_x64(False):
        jm, jstep = _jax_step()
        named, _ = jckpt._named_leaves(jstep.state)
    tstep = _port_step(jm)
    assert [n for n, _ in tstep.state_leaves()] == [n for n, _ in named]
    assert "['opt']['accums']['moment1'][0]" in dict(named)


def test_jax_checkpoint_loads_into_the_port_and_back(tmp_path):
    cfg = _config(jax_tiny_config)
    batch = _batch(cfg)
    with jax.enable_x64(False):
        jm, jstep = _jax_step()
        tstep = _port_step(jm)  # the port's own weights are the same start; the load replaces all
        for _ in range(2):
            jstep(*batch)
        jax_path = str(tmp_path / "jax" / "step_2")
        jstep.save_checkpoint(jax_path, step=2, async_=False)
        want3 = float(np.asarray(jstep(*batch)["loss"]))
    ptrs = [t.data_ptr() for _, t in tstep.state_leaves() if t.dim()]
    manifest = tstep.load_checkpoint(jax_path)
    assert manifest["step"] == 2 and manifest["world"] == 1
    assert tstep.optimizer._global_step == int(tstep.optimizer._step_t) == 2
    flat, _ = jckpt.load(jax_path)
    got = _port_leaves(tstep)
    assert sorted(got) == sorted(flat)
    for n in flat:
        np.testing.assert_array_equal(got[n], flat[n], err_msg=n)
        assert got[n].dtype == flat[n].dtype, n
    assert [t.data_ptr() for _, t in tstep.state_leaves() if t.dim()] == ptrs
    got3 = float(tstep(*batch)["loss"])
    np.testing.assert_allclose(got3, want3, rtol=LOSS_RTOL)

    # the port saves the state it loaded: the JAX files, byte for byte
    port_path = str(tmp_path / "port" / "step_2")
    tstep.load_checkpoint(jax_path)
    tstep.save_checkpoint(port_path, step=2, async_=False)
    for f in ("shard_r0.pdshard", "rank_0.json"):
        with open(os.path.join(jax_path, f), "rb") as a, open(os.path.join(port_path, f),
                                                              "rb") as b:
            assert a.read() == b.read(), f
    ma, mb = (json.load(open(os.path.join(p, "MANIFEST.json"))) for p in (jax_path, port_path))
    ma.pop("time"), mb.pop("time")
    assert ma == mb

    # the reverse: the port takes its 3rd step and saves, the JAX step loads it
    tstep(*batch)
    rev = str(tmp_path / "port" / "step_3")
    tstep.save_checkpoint(rev, step=3)
    ckpt.wait_pending()
    want4 = float(tstep(*batch)["loss"])
    with jax.enable_x64(False):
        _, jstep2 = _jax_step(seed=7)
        jm2 = jstep2.load_checkpoint(rev)
        assert jm2["step"] == 3 and int(np.asarray(jstep2.state["opt"]["step"])) == 3
        flat, _ = ckpt.load(rev)
        named, _ = jckpt._named_leaves(jstep2.state)
        for n, leaf in named:
            np.testing.assert_array_equal(np.asarray(leaf), flat[n], err_msg=n)
        got4 = float(np.asarray(jstep2(*batch)["loss"]))
    np.testing.assert_allclose(got4, want4, rtol=LOSS_RTOL)


def _small_step():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ReLU(), torch.nn.Linear(4, 1))
    opt = port_opt.Adam(0.01, parameters=model.parameters())
    step = train_step(model, opt, lambda m, x: m(x).square().mean(), jit=True, device="cpu")
    step(np.ones((2, 3), "f4"))
    return step


def test_a_flipped_byte_is_corrupt_and_latest_skips_it(tmp_path):
    step = _small_step()
    for s in (1, 2, 3):
        step.save_checkpoint(str(tmp_path / f"step_{s}"), step=s, async_=False)
    os.makedirs(tmp_path / "step_9")  # torn: no manifest
    shard = tmp_path / "step_3" / "shard_r0.pdshard"
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    with pytest.raises(ckpt.CheckpointCorruptError, match="checksum"):
        ckpt.validate(str(tmp_path / "step_3"))
    with pytest.raises(ckpt.CheckpointCorruptError, match="checksum"):
        step.load_checkpoint(str(tmp_path / "step_3"))
    with pytest.raises(ckpt.CheckpointCorruptError, match="no MANIFEST"):
        ckpt.validate(str(tmp_path / "step_9"))
    path, manifest = ckpt.latest_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "step_2") and manifest["step"] == 2
    # the JAX package picks the same one from the port's files
    jpath, _ = jckpt.latest_checkpoint(str(tmp_path))
    assert jpath == path
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) == (None, None)


def test_sweep_tmp_and_keep_rotation(tmp_path):
    step = _small_step()
    os.makedirs(tmp_path / "step_5.tmp")
    assert ckpt.sweep_tmp(str(tmp_path)) == [str(tmp_path / "step_5.tmp")]
    assert not (tmp_path / "step_5.tmp").exists()
    for s in range(1, 6):
        step.save_checkpoint(str(tmp_path / f"step_{s}"), step=s, async_=False, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]


def test_async_writer_publishes_in_order_and_surfaces_failures(tmp_path):
    step = _small_step()
    pend = [step.save_checkpoint(str(tmp_path / f"step_{s}"), step=s, async_=True)
            for s in (1, 2)]
    ckpt.wait_pending(timeout=60)
    assert all(p.done and p.error is None for p in pend)
    assert ckpt.latest_checkpoint(str(tmp_path))[0] == str(tmp_path / "step_2")
    (tmp_path / "blocker").write_text("a file where the snapshot's parent should be")
    step.save_checkpoint(str(tmp_path / "blocker" / "step_3"), step=3, async_=True)
    with pytest.raises(OSError):
        ckpt.wait_pending(timeout=60)
    ckpt.wait_pending(timeout=60)  # the failure was consumed


def test_restore_refuses_another_state(tmp_path):
    step = _small_step()
    step.save_checkpoint(str(tmp_path / "step_1"), step=1, async_=False)
    other = train_step(torch.nn.Linear(3, 1), port_opt.Adam(0.01, parameters=[
        torch.nn.Parameter(torch.zeros(1))]), lambda m, x: m(x).sum(), device="cpu")
    with pytest.raises(ckpt.CheckpointError, match="missing"):
        other.load_checkpoint(str(tmp_path / "step_1"))
    model = torch.nn.Sequential(torch.nn.Linear(3, 5), torch.nn.ReLU(), torch.nn.Linear(5, 1))
    wrong = train_step(model, port_opt.Adam(0.01, parameters=model.parameters()),
                       lambda m, x: m(x).sum(), device="cpu")
    with pytest.raises(ckpt.CheckpointError, match="shape"):
        wrong.load_checkpoint(str(tmp_path / "step_1"))
    with pytest.raises(Exception, match="Queue A item 9"):
        ckpt.save(str(tmp_path / "x"), {}, shardings={})


def test_unused_parameters_are_frozen_as_the_jax_step_freezes_them():
    """A parameter the loss never reads has no gradient after the first
    backward and is named under ``['frozen']``, as the JAX step's
    ``_freeze_unused_params`` moves it."""
    class Two(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.used = torch.nn.Linear(2, 1)
            self.unused = torch.nn.Linear(2, 1)

    m = Two()
    step = train_step(m, port_opt.SGD(0.1, parameters=m.parameters()),
                      lambda m, x: m.used(x).sum(), device="cpu")
    names = [n for n, _ in step.state_leaves()]
    assert "['params']['unused.weight']" in names
    step(np.ones((1, 2), "f4"))
    names = [n for n, _ in step.state_leaves()]
    assert "['frozen']['unused.weight']" in names and "['params']['used.weight']" in names
    assert names[-1] == "['params']['used.bias']" and "['opt']['step']" in names
