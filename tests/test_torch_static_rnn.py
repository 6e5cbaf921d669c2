"""Port parity: the static recurrent layers and a small LSTM language model.

Counterparts of ``tests/test_static_guardrails_rnn.py``'s
``test_cond_shape_mismatch_build_error``, ``test_static_rnn_layers_shapes``,
``test_static_rnn_trains`` and ``test_lstm_oracle`` (``simple_rnn``,
``lstm``, ``gru`` over ``scan``, the JAX weight layout), and the main
path's two programs at a small size (vocabulary 50, H 16, 2 layers, 5
steps, batch 3, dropout 0): the LSTM language model trained three steps
under SGD with the global-norm clip and under Momentum, and its greedy
continuation, a ``while_loop`` whose body runs one step of both layers
(a ``scan`` of length 1) and an ``argmax``, bounded (``max_iters``, a
masked ``scan``) and unbounded. Both packages build the same programs,
the port's scope is a copy of the JAX startup's, and

- f32 losses agree within 1e-5 relative, each parameter after three steps
  within 1e-5 of its tensor's largest entry;
- greedy tokens are equal: JAX, port bounded, port unbounded, and a host
  loop of the one-step program; the unbounded form's runs are counted as
  uncaptured by the executor's store, the bounded form's are not.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.optimizer import ClipGradByGlobalNorm as JaxClipGlobal  # noqa: E402

from paddle_tpu_torch import convert, ops, static  # noqa: E402
from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm  # noqa: E402

torch.set_num_threads(1)

PKGS = ((jstatic, jops), (static, ops))
RTOL = 1e-5
VOCAB, HIDDEN, LAYERS, STEPS, BATCH = 50, 16, 2, 5, 3
PROMPT, NEW = 3, 6


@pytest.fixture(autouse=True)
def both_static():
    for st in (jstatic, static):
        st.reset_default_programs()
        st.global_scope().clear()
        st.enable_static()
    yield
    for st in (jstatic, static):
        st.disable_static()
        st.reset_default_programs()
        st.global_scope().clear()


def _seq_data(B=4, T=6, D=8, seed=0):
    return np.random.RandomState(seed).randn(B, T, D).astype("float32")


def _copy_scope():
    jscope = jstatic.global_scope()
    convert.scope_from_numpy({n: np.asarray(jscope.get(n)) for n in jscope.var_names()},
                             scope=static.global_scope(), device="cpu")


def _executors():
    jexe = jstatic.Executor()
    jexe.run_startup()
    _copy_scope()
    return jexe, static.Executor("cpu")


def _normalized_consts(prog_dict):
    """``Program.to_dict()`` with captured constants renamed by their
    order of appearance (their names carry a per-package counter)."""
    text = repr(prog_dict)
    names = {}
    for m in re.finditer(r"const\d+_\d+", text):
        names.setdefault(m.group(0), f"CONST{len(names)}")
    return re.sub(r"const\d+_\d+", lambda m: names[m.group(0)], text)


def _assert_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= RTOL * scale, (what, np.abs(got - want).max(), scale)


def test_cond_shape_mismatch_build_error():
    for st, o in PKGS:
        pred = st.data("p", [], "bool")
        with pytest.raises(ValueError, match="shape mismatch"):
            st.cond(pred, lambda: o.full([2], 1.0), lambda: o.full([3], 2.0))


@pytest.mark.parametrize("layer,n_states", [("simple_rnn", 1), ("lstm", 2), ("gru", 1)])
def test_static_rnn_layers_shapes(layer, n_states):
    fetches = []
    for st, o in PKGS:
        x = st.data("x", [4, 6, 8], "float32")
        out, finals = getattr(st.nn, layer)(x, 5)
        assert list(out.shape) == [4, 6, 5] and len(finals) == n_states
        fetches.append([out] + list(finals))
    jexe, pexe = _executors()
    feed = {"x": _seq_data()}
    want = jexe.run(feed=feed, fetch_list=fetches[0])
    got = pexe.run(feed=feed, fetch_list=fetches[1])
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_close(g, w, f"fetch {i}")
    np.testing.assert_allclose(got[0][:, -1, :], got[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layer", ["simple_rnn", "lstm", "gru"])
def test_static_rnn_trains(layer):
    """Adam through the scan: the first three steps' losses and the
    parameters after them agree; 40 steps fit the toy target in both."""
    fetches = []
    for st, o in PKGS:
        x = st.data("x", [4, 6, 8], "float32")
        target = st.data("t", [4, 1], "float32")
        out, finals = getattr(st.nn, layer)(x, 8)
        w_out = st.nn.create_parameter([8, 1], "float32")
        loss = o.mean(o.square(o.subtract(o.matmul(finals[0], w_out), target)))
        st.optimizer.Adam(learning_rate=0.02).minimize(loss)
        fetches.append(loss)
    jexe, pexe = _executors()
    feed = {"x": _seq_data(), "t": np.random.RandomState(1).randn(4, 1).astype("float32")}
    losses = {"jax": [], "port": []}
    for step in range(40):
        losses["jax"].append(float(jexe.run(feed=feed, fetch_list=[fetches[0]])[0]))
        losses["port"].append(float(pexe.run(feed=feed, fetch_list=[fetches[1]])[0]))
        if step < 3:
            assert abs(losses["port"][-1] - losses["jax"][-1]) <= RTOL * losses["jax"][-1]
        if step == 2:
            for n in static.global_scope().var_names():
                if n.startswith("param_"):
                    _assert_close(static.global_scope().numpy(n),
                                  np.asarray(jstatic.global_scope().get(n)), n)
    for got in losses.values():
        assert got[-1] < got[0] * 0.3, (got[0], got[-1])


def test_lstm_oracle():
    H, D, B, T = 3, 4, 2, 5
    fetches = []
    for st, o in PKGS:
        x = st.data("x", [B, T, D], "float32")
        out, _ = st.nn.lstm(x, H)
        fetches.append(out)
    jexe, pexe = _executors()
    X = _seq_data(B, T, D, seed=3)
    o_port = pexe.run(feed={"x": X}, fetch_list=[fetches[1]])[0]
    _assert_close(o_port, jexe.run(feed={"x": X}, fetch_list=[fetches[0]])[0])
    scope = static.global_scope()
    w_ih, w_hh, b = (scope.numpy(f"param_{i}") for i in range(3))

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    h = np.zeros((B, H), np.float32)
    c = np.zeros((B, H), np.float32)
    for t in range(T):
        i, f, gg, oo = np.split(X[:, t] @ w_ih + h @ w_hh + b, 4, axis=-1)
        c = sigmoid(f) * c + sigmoid(i) * np.tanh(gg)
        h = sigmoid(oo) * np.tanh(c)
        np.testing.assert_allclose(o_port[:, t], h, rtol=1e-4, atol=1e-5)


# -- the LSTM language model and its greedy continuation -----------------------------


def ptb_lm(st, o, vocab=VOCAB, hidden=HIDDEN, layers=LAYERS, steps=STEPS, batch=BATCH,
           dropout=0.0):
    """The PTB LSTM language model (Zaremba et al. 2014) as a static
    program: ``(loss, logits)``; ``labels`` is ``[batch, steps, 1]``."""
    ids = st.data("ids", [batch, steps], "int64")
    labels = st.data("labels", [batch, steps, 1], "int64")
    x = st.nn.dropout(st.nn.embedding(ids, [vocab, hidden]), dropout)
    for _ in range(layers):
        x, _ = st.nn.lstm(x, hidden)
        x = st.nn.dropout(x, dropout)
    logits = st.nn.fc(x, vocab, num_flatten_dims=2)
    return o.mean(o.softmax_with_cross_entropy(logits, labels)), logits


def _lm_step(st, o, tok, states, vocab, hidden, layers, batch):
    """One step of the language model on ``tok`` ``[batch]``: the next
    token (``argmax``) and the new ``[h, c]`` of each layer."""
    x = st.nn.embedding(o.reshape(tok, [batch, 1]), [vocab, hidden])
    new_states = []
    for k in range(layers):
        x, (h, c) = st.nn.lstm(x, hidden, init_h=states[2 * k], init_c=states[2 * k + 1])
        new_states += [h, c]
    logits = st.nn.fc(x, vocab, num_flatten_dims=2)
    return o.reshape(o.argmax(logits, axis=-1), [batch]), new_states


def greedy_lm(st, o, vocab=VOCAB, hidden=HIDDEN, layers=LAYERS, batch=BATCH, prompt_len=PROMPT,
              new_tokens=NEW, bounded=True):
    """Greedy continuation: a ``while_loop`` over ``prompt_len + new_tokens
    - 1`` steps whose input is the prompt's token while there is one, then
    the last ``argmax``; returns the ``[batch, new_tokens]`` new tokens.
    ``bounded``: ``max_iters`` is the trip count (a masked scan)."""
    prompt = st.data("prompt", [batch, prompt_len], "int64")
    n_iter = prompt_len + new_tokens - 1
    ppos = np.arange(prompt_len, dtype=np.int64)[None, :]
    opos = np.arange(prompt_len - 1, n_iter, dtype=np.int64)[None, :]
    no_tok = np.zeros((batch, prompt_len), np.int64)

    def body(i, tok, out, *states):
        from_prompt = o.sum(o.where(o.equal(ppos, i), prompt, no_tok), axis=1)
        inp = o.where(o.less_than(i, np.int64(prompt_len)), from_prompt, tok)
        nxt, new_states = _lm_step(st, o, inp, states, vocab, hidden, layers, batch)
        out = o.where(o.equal(opos, i), o.reshape(nxt, [batch, 1]), out)
        return [o.add(i, np.int64(1)), nxt, out] + new_states

    init = ([o.full([], 0, "int64"), o.full([batch], 0, "int64"),
             o.full([batch, new_tokens], 0, "int64")]
            + [o.zeros([batch, hidden], "float32") for _ in range(2 * layers)])
    finals = st.nn.while_loop(lambda i, *rest: o.less_than(i, np.int64(n_iter)), body, init,
                              max_iters=n_iter if bounded else None)
    return finals[2]


def _lm_batches(n, vocab=VOCAB, steps=STEPS, batch=BATCH, seed=0):
    """``n`` batches of a token stream made from ``seed``: ids and the next
    tokens as labels."""
    stream = np.random.RandomState(seed).randint(0, vocab, size=n * batch * steps + 1)
    out = []
    for k in range(n):
        s = stream[k * batch * steps:(k + 1) * batch * steps + 1]
        out.append({"ids": s[:-1].reshape(batch, steps).astype(np.int64),
                    "labels": s[1:].reshape(batch, steps, 1).astype(np.int64)})
    return out


@pytest.mark.parametrize("opt", ["sgd_clip", "momentum"])
def test_small_lm_trains_like_jax(opt):
    fetches = []
    for st, o in PKGS:
        loss, _ = ptb_lm(st, o)
        if opt == "sgd_clip":
            clip = (JaxClipGlobal if st is jstatic else ClipGradByGlobalNorm)(5.0)
            st.optimizer.SGD(1.0, grad_clip=clip).minimize(loss)
        else:
            st.optimizer.Momentum(learning_rate=0.5, momentum=0.9).minimize(loss)
        fetches.append(loss)
    assert (_normalized_consts(static.default_main_program().to_dict())
            == _normalized_consts(jstatic.default_main_program().to_dict()))
    jexe, pexe = _executors()
    for feed in _lm_batches(3):
        want = float(jexe.run(feed=feed, fetch_list=[fetches[0]])[0])
        got = float(pexe.run(feed=feed, fetch_list=[fetches[1]])[0])
        assert abs(got - want) <= RTOL * abs(want), (got, want)
    names = [n for n in static.global_scope().var_names() if n.startswith("param_")]
    assert len(names) >= 9
    for n in names:
        _assert_close(static.global_scope().numpy(n), np.asarray(jstatic.global_scope().get(n)), n)


def test_greedy_continuation_bounded_unbounded_and_host_loop():
    """Tokens equal in JAX and the port, bounded and unbounded, and a host
    loop of the one-step program; the executor's store counts the
    unbounded form's runs as uncaptured."""
    prompts = np.random.RandomState(7).randint(0, VOCAB, size=(BATCH, PROMPT)).astype(np.int64)
    outs = {}
    for bounded in (True, False):
        for st in (jstatic, static):
            st.reset_default_programs()
        fetches = [greedy_lm(st, o, bounded=bounded) for st, o in PKGS]
        assert (_normalized_consts(static.default_main_program().to_dict())
                == _normalized_consts(jstatic.default_main_program().to_dict()))
        if bounded:
            jexe, pexe = _executors()
        before = pexe.store.uncaptured
        outs[("jax", bounded)] = np.asarray(
            jexe.run(feed={"prompt": prompts}, fetch_list=[fetches[0]])[0])
        outs[("port", bounded)] = pexe.run(feed={"prompt": prompts}, fetch_list=[fetches[1]])[0]
        assert pexe.store.uncaptured - before == (0 if bounded else 1)
    want = outs[("jax", True)]
    assert want.shape == (BATCH, NEW) and want.dtype == np.int64
    for k, v in outs.items():
        np.testing.assert_array_equal(v, want, err_msg=str(k))

    # the host loop of the one-step program
    static.reset_default_programs()
    tok = static.data("tok", [BATCH], "int64")
    states = [static.data(f"s{k}", [BATCH, HIDDEN], "float32") for k in range(2 * LAYERS)]
    nxt, new_states = _lm_step(static, ops, tok, states, VOCAB, HIDDEN, LAYERS, BATCH)
    vals = [np.zeros((BATCH, HIDDEN), np.float32)] * (2 * LAYERS)
    got, prev = [], None
    for i in range(PROMPT + NEW - 1):
        feed = {"tok": prompts[:, i] if i < PROMPT else prev}
        feed.update({f"s{k}": v for k, v in enumerate(vals)})
        prev, *vals = pexe.run(feed=feed, fetch_list=[nxt] + new_states)
        if i >= PROMPT - 1:
            got.append(prev)
    np.testing.assert_array_equal(np.stack(got, 1), want)
