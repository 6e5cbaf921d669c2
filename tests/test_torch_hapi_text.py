"""The hapi text layers in the port (``paddle_tpu_torch/incubate/hapi_text.py``)
against the JAX package's (``paddle_tpu/incubate/hapi_text.py``).

The CRF's negative log-likelihood and its gradients in the emission and
the transition agree with the JAX layer's (rel 1e-5 / 1e-4) and with an
enumeration of every label path; positions past a row's length change
nothing. Viterbi paths equal the JAX layer's and the brute force's, ties
included (the first maximum). ``CNNEncoder`` and ``SequenceTagging``
(weights carried by ``convert``) give the JAX outputs within 1e-5, and
``SequenceTagging`` meets the JAX Conll05st training test's criteria
(``tests/test_hapi_text.py``): the CRF loss falls by 30% in 8 Adam steps
and decoding beats the majority class."""
import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.incubate import hapi_text as jht
from paddle_tpu_torch import convert
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.framework import random as port_random
from paddle_tpu_torch.incubate import hapi_text as tht
from paddle_tpu_torch.text import Conll05st

torch.set_num_threads(1)

NLL_RTOL, GRAD_RTOL, OUT_ATOL = 1e-5, 1e-4, 1e-5


def _brute_force(emission, transition, length):
    """Every label path of one sequence: (logZ, best path, best score)."""
    n = emission.shape[1]
    start, stop, trans = transition[0], transition[1], transition[2:]
    scores = {}
    for path in itertools.product(range(n), repeat=length):
        s = start[path[0]] + emission[0, path[0]]
        for t in range(1, length):
            s += trans[path[t - 1], path[t]] + emission[t, path[t]]
        scores[path] = s + stop[path[-1]]
    vals = np.asarray(list(scores.values()), np.float64)
    logz = np.log(np.exp(vals - vals.max()).sum()) + vals.max()
    best = max(scores, key=scores.get)  # the first path in order among ties
    return logz, list(best), scores


def _gold(emission, transition, labels, length):
    s = transition[0, labels[0]] + emission[0, labels[0]]
    for t in range(1, length):
        s += transition[2 + labels[t - 1], labels[t]] + emission[t, labels[t]]
    return s + transition[1, labels[length - 1]]


def _crf_pair(n, seed=0):
    jpaddle.seed(seed)
    jcrf = jht.LinearChainCRF(n)
    tcrf = tht.LinearChainCRF(n, device="cpu")
    with torch.no_grad():
        tcrf.transition.copy_(torch.from_numpy(np.asarray(jcrf.transition.numpy())))
    return jcrf, tcrf


def _case(rng, b, t, n, short=True):
    emission = rng.randn(b, t, n).astype(np.float32)
    labels = rng.randint(0, n, (b, t)).astype(np.int64)
    lengths = np.full(b, t, np.int64)
    if short:
        lengths[1::2] = rng.randint(1, t, len(lengths[1::2]))
    return emission, labels, lengths


def test_nll_and_gradients_equal_the_jax_layers():
    rng = np.random.RandomState(0)
    n = 5
    jcrf, tcrf = _crf_pair(n)
    emission, labels, lengths = _case(rng, 4, 7, n)
    je = jpaddle.to_tensor(emission, stop_gradient=False)
    jnll = jcrf(je, jpaddle.to_tensor(labels), jpaddle.to_tensor(lengths))
    jnll.sum().backward()
    te = torch.from_numpy(emission).requires_grad_()
    tnll = tcrf(te, torch.from_numpy(labels), torch.from_numpy(lengths))
    tnll.sum().backward()
    np.testing.assert_allclose(tnll.detach().numpy(), np.asarray(jnll.numpy()), rtol=NLL_RTOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(je.grad.numpy()), rtol=GRAD_RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(tcrf.transition.grad.numpy(),
                               np.asarray(jcrf.transition.grad.numpy()), rtol=GRAD_RTOL,
                               atol=1e-7)


@pytest.mark.parametrize("length", [1, 3, 4])
def test_nll_matches_enumeration(length):
    rng = np.random.RandomState(length)
    n, t = 3, 4
    _, tcrf = _crf_pair(n, seed=length)
    trans = tcrf.transition.detach().numpy().astype(np.float64)
    emission, labels, _ = _case(rng, 1, t, n, short=False)
    nll = float(tcrf(emission, labels, np.asarray([length]))[0])
    logz, _, _ = _brute_force(emission[0].astype(np.float64), trans, length)
    gold = _gold(emission[0].astype(np.float64), trans, labels[0], length)
    np.testing.assert_allclose(nll, logz - gold, rtol=NLL_RTOL)


def test_positions_past_the_length_change_nothing():
    rng = np.random.RandomState(2)
    n, t, length = 3, 6, 4
    _, tcrf = _crf_pair(n)
    e1 = rng.randn(1, t, n).astype(np.float32)
    e2 = e1.copy()
    e2[:, length:] = 99.0
    labels = rng.randint(0, n, (1, t)).astype(np.int64)
    l2 = labels.copy()
    l2[:, length:] = (labels[:, length:] + 1) % n
    lengths = np.asarray([length], np.int64)
    v1 = float(tcrf(e1, labels, lengths)[0])
    v2 = float(tcrf(e2, l2, lengths)[0])
    np.testing.assert_allclose(v1, v2, rtol=1e-6)
    dec = tht.CRFDecoding(tcrf)
    p1, p2 = dec(e1, lengths).numpy(), dec(e2, lengths).numpy()
    np.testing.assert_array_equal(p1[:, :length], p2[:, :length])
    assert (p1[0, length:] == p1[0, length - 1]).all()  # the last label, repeated


@pytest.mark.parametrize("ties", [False, True])
def test_viterbi_equals_the_jax_layer_and_brute_force(ties):
    rng = np.random.RandomState(1)
    n, t, b = 3, 5, 4
    jcrf, tcrf = _crf_pair(n, seed=1)
    emission, _, lengths = _case(rng, b, t, n)
    if ties:  # every path ties: the first maximum everywhere
        emission[:] = 0.0
        with torch.no_grad():
            tcrf.transition.zero_()
        jcrf.transition.set_value(np.zeros((n + 2, n), np.float32))
    got = tht.CRFDecoding(tcrf)(emission, lengths).numpy()
    want = np.asarray(jht.CRFDecoding(jcrf)(jpaddle.to_tensor(emission),
                                             jpaddle.to_tensor(lengths)).numpy())
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and got.shape == (b, t)
    trans = tcrf.transition.detach().numpy().astype(np.float64)
    for i in range(b):
        _, best, scores = _brute_force(emission[i].astype(np.float64), trans, int(lengths[i]))
        path = got[i, :lengths[i]].tolist()
        assert scores[tuple(path)] == scores[tuple(best)]
        if not ties:
            assert path == best


def test_cnn_encoder_equals_the_jax_layer():
    jpaddle.seed(0)
    jenc = jht.CNNEncoder(num_channels=8, num_filters=4, filter_sizes=(2, 3, 4))
    tenc = tht.CNNEncoder(num_channels=8, num_filters=4, filter_sizes=(2, 3, 4), device="cpu")
    np_state = {k: np.asarray(v.numpy()) for k, v in jenc.state_dict().items()}
    tenc.load_state_dict(convert._state_from_numpy(np_state, tenc))
    x = np.random.RandomState(0).randn(2, 8, 10).astype(np.float32)
    want = np.asarray(jenc(jpaddle.to_tensor(x)).numpy())
    got = tenc(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 12)
    np.testing.assert_allclose(got, want, atol=OUT_ATOL, rtol=0)
    jmean = jht.Conv1dPoolLayer(8, 4, 3, pool_type="avg")
    tmean = tht.Conv1dPoolLayer(8, 4, 3, pool_type="avg", device="cpu")
    tmean.load_state_dict(convert._state_from_numpy(
        {k: np.asarray(v.numpy()) for k, v in jmean.state_dict().items()}, tmean))
    np.testing.assert_allclose(tmean(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jmean(jpaddle.to_tensor(x)).numpy()), atol=OUT_ATOL)


def _tagging_pair(vocab, labels, emb=16, hid=16):
    jpaddle.seed(0)
    jm = jht.SequenceTagging(vocab, labels, word_emb_dim=emb, hidden_size=hid)
    tm = tht.SequenceTagging(vocab, labels, word_emb_dim=emb, hidden_size=hid)
    np_state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert sorted(set(tm.state_dict()) - {"decoder.crf.transition"}) == sorted(np_state)
    tm.load_state_dict(convert.sequence_tagging_state_from_numpy(np_state, tm))
    return jm, tm


def _conll(n=None):
    ds = Conll05st(mode="train")
    samples = ds.samples[:n]
    t = max(len(s[0]) for s in samples)
    words = np.zeros((len(samples), t), np.int64)
    labels = np.zeros((len(samples), t), np.int64)
    lengths = np.zeros(len(samples), np.int64)
    for i, (w, _, _, lab) in enumerate(samples):
        words[i, :len(w)] = w
        labels[i, :len(lab)] = lab
        lengths[i] = len(w)
    return ds, words, labels, lengths


def test_sequence_tagging_equals_the_jax_model():
    ds, words, labels, lengths = _conll(6)
    jm, tm = _tagging_pair(ds.vocab_size, ds.num_labels)
    jt = [jpaddle.to_tensor(a) for a in (words, labels, lengths)]
    want = float(jm(*jt).numpy())
    got = float(tm(words, labels, lengths))
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)
    want_em = np.asarray(jm._emission(jt[0]).numpy())
    np.testing.assert_allclose(tm._emission(words).detach().numpy(), want_em, atol=OUT_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tm.decode(words, lengths).numpy(),
                                  np.asarray(jm.decode(jt[0], jt[2]).numpy()))


def test_sequence_tagging_trains_on_conll05():
    """The JAX test's criteria: 8 full-batch Adam steps at lr 0.01 on 96
    sentences drop the CRF NLL by 30%, and Viterbi beats the majority class
    on 32."""
    ds, words, labels, lengths = _conll()
    port_random.seed(0)
    model = tht.SequenceTagging(ds.vocab_size, ds.num_labels, word_emb_dim=32, hidden_size=32)
    adam = port_opt.Adam(learning_rate=0.01, parameters=model.parameters())
    losses = []
    for _ in range(8):
        loss = model(words[:96], labels[:96], lengths[:96])
        loss.backward()
        adam.step()
        adam.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses
    paths = model.decode(words[:32], lengths[:32]).numpy()
    mask = np.arange(words.shape[1])[None, :] < lengths[:32, None]
    acc = (paths == labels[:32])[mask].mean()
    majority = max((labels[:32][mask] == k).mean() for k in range(ds.num_labels))
    assert acc > majority, (acc, majority)


@pytest.mark.parametrize("name", jht.__all__)
def test_every_jax_name_is_here(name):
    assert name in tht.__all__ and getattr(tht, name) is not None
