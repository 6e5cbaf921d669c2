"""The port's cost model against the JAX package's, and its counts against
the closed forms.

- A matmul counts ``2·M·N·K``, XLA's golden (the JAX test's
  ``test_matmul_flops_golden_and_mfu_math`` holds XLA's count within 5% of
  it; here the port's count is held to the JAX record's within the same 5%
  and to the formula exactly), and the MFU / HBM-share math under explicit
  peaks.
- Each hand-written kernel's wrapper counts the FLOPs and bytes of the
  function it computes by ``PERF.md`` section 6's bound formulas, one case a
  row, written out here from the shapes; on the CPU the wrapper runs its
  plain version and counts the same, and none of the plain version's aten
  ops is counted again. The attention kernels launch only on the card, so
  their formulas are held through the cost functions the wrappers report.
- The peak table's H100 rows (data-sheet figures), the nominal CPU sheet,
  ``FLAGS_device_peaks`` overrides (with the memory planner's budget read
  through them), ``/costz`` keys equal to the JAX payload's.
- A compiled step on the CPU records its cost at a signature's first call
  and books every call into ``cost/executed_flops``; a small MLP's count
  equals its closed form exactly, and tiny BERT and ResNet training steps
  come within 5% of the closed forms ``PERF.md`` states.
- The JAX ``roofline_class`` and ``TrainingMonitor.close`` tests, run on
  both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.monitor import cost_model as jcost  # noqa: E402

import _port_counterparts as counterparts  # noqa: E402
from paddle_tpu_torch import monitor  # noqa: E402
from paddle_tpu_torch.flags import set_flags  # noqa: E402
from paddle_tpu_torch.framework.jit import eval_step, train_step  # noqa: E402
from paddle_tpu_torch.monitor import cost_model  # noqa: E402
from paddle_tpu_torch.ops.cuda import (conv_bn_relu, flash_attention, int8_matmul,  # noqa: E402
                                       layernorm_residual, optimizer_update, pool_backward)

JAX_TESTS = counterparts.jax_tests("test_cost_model")
PURE = ["test_roofline_classification", "test_monitor_close_flushes_partial_window",
        "test_monitor_close_respects_silence_and_empty_window",
        "test_monitor_close_aborts_inflight_step"]
NAMESPACES = {
    "jax": counterparts.namespace(JAX_TESTS),
    "port": counterparts.namespace(JAX_TESTS, cost_model=cost_model, monitor=monitor),
}


@pytest.fixture(autouse=True)
def _clean():
    monitor.reset_registry(unregister=True)
    cost_model.reset_cost_records()
    yield
    set_flags({"device_peaks": ""})
    monitor.reset_registry(unregister=True)
    cost_model.reset_cost_records()


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("test_name", PURE)
def test_jax_counterpart(test_name, pkg, request):
    counterparts.call(NAMESPACES[pkg], test_name, request)


def test_matmul_flops_golden_and_mfu_math():
    M, K, N = 64, 128, 32
    lowered = jax.jit(lambda a, b: a @ b).lower(jnp.zeros((M, K), jnp.float32),
                                               jnp.zeros((K, N), jnp.float32))
    jrec = jcost.capture("golden", lowered=lowered, compiled=lowered.compile(), key="golden")
    a, b = torch.zeros(M, K), torch.zeros(K, N)
    with cost_model.count_work() as work:
        out = a @ b
    rec = cost_model.capture("golden", cost=work, key="golden")
    want = 2.0 * M * N * K
    assert rec.flops == want
    assert rec.flops == pytest.approx(jrec.flops, rel=0.05)
    assert rec.bytes_accessed == (M * K + K * N + M * N) * 4
    assert work.ops == {"aten.mm": [1, want, (M * K + K * N + M * N) * 4]}
    assert out.shape == (M, N)
    set_flags({"device_peaks": "flops=1e9,hbm_bw=1e9,ici_bw=1e9"})
    peaks = cost_model.device_peaks()
    assert peaks["flops"] == 1e9 and peaks["nominal"] is False
    assert cost_model.mfu(rec.flops * 10.0, peaks) == pytest.approx(rec.flops * 10.0 / 1e9)
    assert cost_model.hbm_bw_util(rec.bytes_accessed * 2.0, peaks) == \
        pytest.approx(rec.bytes_accessed * 2.0 / 1e9)


def test_note_run_feeds_the_executed_work_ledger():
    rec = cost_model.capture("ledger", cost={"flops": 5.0, "bytes accessed": 7.0}, mem={})
    cost_model.note_run(rec, n=3)
    cost_model.note_run(None)
    assert monitor.counter("cost/executed_flops").value == 15.0
    assert monitor.counter("cost/executed_bytes").value == 21.0
    assert rec.runs == 3 and not rec.partial
    partial = cost_model.capture("partial", key="p")
    assert partial.partial and partial.flops == 0.0


def test_h100_rows_nominal_cpu_and_overrides():
    sxm = cost_model.device_peaks(kind="NVIDIA H100 80GB HBM3")
    assert (sxm["flops"], sxm["hbm_bw"], sxm["ici_bw"]) == (989.4e12, 3.35e12, 450e9)
    assert sxm["nominal"] is False
    pcie = cost_model.device_peaks(kind="NVIDIA H100 PCIe")
    assert (pcie["flops"], pcie["hbm_bw"]) == (756e12, 2.0e12)
    cpu = cost_model.device_peaks(device="cpu")
    assert cpu["nominal"] is True and cpu["kind"] == "cpu"
    assert set(cpu) == set(jcost.device_peaks(kind="cpu"))
    set_flags({"device_peaks": "flops=5e13, hbm_bw=2e12"})
    p = cost_model.device_peaks(kind="warp-drive-9000")
    assert p["flops"] == 5e13 and p["hbm_bw"] == 2e12 and p["nominal"] is False
    set_flags({"device_peaks": "flops=oops,junk,=3"})
    assert cost_model.device_peaks(kind="NVIDIA H100 80GB HBM3")["flops"] == 989.4e12


def test_the_memory_budget_reads_the_peak_sheet():
    from paddle_tpu_torch.analysis import memory

    assert memory.hbm_budget_bytes("cpu") == 0  # unknown on the CPU: never blocks
    set_flags({"device_peaks": "hbm_bytes=12345"})
    assert memory.hbm_budget_bytes("cpu") == 12345
    assert cost_model.device_peaks(kind="NVIDIA H100 80GB HBM3")["hbm_bytes"] == 12345


def test_costz_payload_keys_equal_the_jax_payloads():
    rec = cost_model.capture("k", cost={"flops": 1.0, "bytes accessed": 2.0},
                             mem={"argument_size_in_bytes": 4})
    jrec = jcost.capture("k", key="k")
    assert set(rec.to_dict()) == set(jrec.to_dict())
    assert set(cost_model.costz_payload()) == set(jcost.costz_payload())
    jcost.reset_cost_records()


# -- each kernel wrapper against PERF.md's bound formula, one case a row -----------------


def _ln_case(dtype, res_dtype):
    rows, h = 37, 64
    g = torch.Generator().manual_seed(0)
    x = torch.randn(rows, h, generator=g).to(dtype)
    r = torch.randn(rows, h, generator=g).to(res_dtype)
    w, b = torch.ones(h), torch.zeros(h)
    es, rs = x.element_size(), r.element_size()
    # row 1 / 1b: x, residual, w, b read; y (x's type), mean, rstd written
    want = rows * h * (es + rs) + 8 * h + rows * h * es + 8 * rows
    return (lambda: layernorm_residual.layernorm_residual_fwd(x, r, w, b)), 0, want


def _ln_bwd_case(dtype):
    rows, h = 37, 64
    g = torch.Generator().manual_seed(1)
    x, r, dy = (torch.randn(rows, h, generator=g).to(dtype) for _ in range(3))
    w = torch.ones(h)
    mean, rstd = torch.zeros(rows), torch.ones(rows)
    es = x.element_size()
    # row 2 / 2b: x, residual, w, mean, rstd, dy read; da, dw, db written
    want = 3 * rows * h * es + 4 * h + 8 * rows + rows * h * es + 8 * h
    return (lambda: layernorm_residual.layernorm_residual_bwd(x, r, w, mean, rstd, dy)), 0, want


def _mm_case(name, dtype):
    m, k, n = 50, 32, 24
    g = torch.Generator().manual_seed(2)
    p2 = torch.randn(m, k, generator=g).to(dtype)
    w2 = torch.randn(k, n, generator=g).to(dtype)
    es = p2.element_size()
    flops = 2 * m * k * n  # rows 8, 9 (3xTF32 counted once), 8c, 9c
    if name == "mm_affine_relu":
        scale, shift = torch.ones(n), torch.zeros(n)
        want = (m * k + k * n + m * n) * es + 2 * 4 * n
        return (lambda: conv_bn_relu.mm_affine_relu(p2, w2, scale, shift)), flops, want
    want = (m * k + k * n + m * n) * es + 4 * n  # co and its f32 column sums
    return (lambda: conv_bn_relu.mm_stats(p2, w2)), flops, want


def _bn_case(name, dtype):
    m, n = 50, 24
    g = torch.Generator().manual_seed(3)
    co = torch.randn(m, n, generator=g).to(dtype)
    dy = torch.randn(m, n, generator=g).to(dtype)
    v = [torch.rand(n, generator=g) for _ in range(4)]
    es = co.element_size()
    cases = {  # rows 10-13 (10b-13b): M·N operands plus the f32 vectors
        "centered_sumsq": (lambda: conv_bn_relu.centered_sumsq(co, v[0]),
                           m * n * es + 8 * n),
        "bn_relu": (lambda: conv_bn_relu.bn_relu(co, v[0], v[1]), 2 * m * n * es + 8 * n),
        "bn_bwd_partials": (lambda: conv_bn_relu.bn_bwd_partials(co, dy, v[0], v[1]),
                            2 * m * n * es + 16 * n),
        "bn_bwd_dco": (lambda: conv_bn_relu.bn_bwd_dco(co, dy, *v),
                       2 * m * n * es + 4 * m * n + 16 * n),
    }
    fn, want = cases[name]
    return fn, 0, want


def _momentum_case():
    shapes = [(3, 5), (7,), (2, 2, 2)]
    g = torch.Generator().manual_seed(4)
    ps, gs, vs = ([torch.randn(s, generator=g) for s in shapes] for _ in range(3))
    p_total = sum(int(np.prod(s)) for s in shapes)
    # row 14: 20·P bytes (param, grad, velocity read; param, velocity written)
    return (lambda: optimizer_update.fused_momentum_update_multi(ps, gs, vs, 0.1)), 0, \
        20 * p_total


def _int8_case():
    m, k, n = 9, 16, 12
    g = torch.Generator().manual_seed(5)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    # row 15: 2·M·K·N operations; M·K + K·N + 4·M·N bytes
    return (lambda: int8_matmul.int8_matmul(x, w)), 2 * m * k * n, m * k + k * n + 4 * m * n


def _pool_case(dtype):
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 3, 8, 8, generator=g).to(dtype)
    y = torch.nn.functional.max_pool2d(x.float(), 2, 2).to(dtype)
    dy = torch.randn(y.shape, generator=g).to(dtype)
    es = x.element_size()
    # row 16 / 16c: (|x| + |y| + |dy| + |dx|) elements of the type
    want = (2 * x.numel() + y.numel() + dy.numel()) * es
    return (lambda: pool_backward.max_pool2d_backward(x, y, dy, (2, 2), (2, 2), (0, 0))), 0, want


BF16, F32 = torch.bfloat16, torch.float32
WRAPPER_CASES = {
    "1 layernorm_residual_fwd f32": lambda: _ln_case(F32, F32),
    "1b layernorm_residual_fwd bf16": lambda: _ln_case(BF16, BF16),
    "1b layernorm_residual_fwd mixed": lambda: _ln_case(BF16, F32),
    "2 layernorm_residual_bwd f32": lambda: _ln_bwd_case(F32),
    "2b layernorm_residual_bwd bf16": lambda: _ln_bwd_case(BF16),
    "8 mm_affine_relu f32": lambda: _mm_case("mm_affine_relu", F32),
    "8c mm_affine_relu bf16": lambda: _mm_case("mm_affine_relu", BF16),
    "9 mm_stats f32": lambda: _mm_case("mm_stats", F32),
    "9c mm_stats bf16": lambda: _mm_case("mm_stats", BF16),
    "10 centered_sumsq f32": lambda: _bn_case("centered_sumsq", F32),
    "10b centered_sumsq bf16": lambda: _bn_case("centered_sumsq", BF16),
    "11 bn_relu f32": lambda: _bn_case("bn_relu", F32),
    "11b bn_relu bf16": lambda: _bn_case("bn_relu", BF16),
    "12 bn_bwd_partials f32": lambda: _bn_case("bn_bwd_partials", F32),
    "12b bn_bwd_partials bf16": lambda: _bn_case("bn_bwd_partials", BF16),
    "13 bn_bwd_dco f32": lambda: _bn_case("bn_bwd_dco", F32),
    "13b bn_bwd_dco bf16": lambda: _bn_case("bn_bwd_dco", BF16),
    "14 momentum_update": _momentum_case,
    "15 int8_matmul": _int8_case,
    "16 max_pool2d_backward f32": lambda: _pool_case(F32),
    "16c max_pool2d_backward bf16": lambda: _pool_case(BF16),
}


@pytest.mark.parametrize("row", list(WRAPPER_CASES))
def test_kernel_wrapper_counts_its_bound_formula(row):
    fn, flops, nbytes = WRAPPER_CASES[row]()
    with cost_model.count_work() as work:
        fn()
    assert list(work.kernels.values()) == [[1, float(flops), float(nbytes)]], work.kernels
    assert work.ops == {}  # the plain version's aten ops are the kernel's own
    assert (work.flops, work.bytes_accessed) == (flops, nbytes)


def _attn(b, h, lq, lk, d, dtype, bias=False):
    g = torch.Generator().manual_seed(7)
    q = torch.randn(b, h, lq, d, generator=g).to(dtype)
    k = torch.randn(b, h, lk, d, generator=g).to(dtype)
    v = torch.randn(b, h, lk, d, generator=g).to(dtype)
    bias_t = torch.zeros(b, 1, 1, lk).expand(b, h, lq, lk) if bias else None
    return q, k, v, bias_t


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_attention_costs_are_the_bound_formulas(dtype, causal):
    """Rows 3-7 (and 3b-7b): forward ``4·B·H·L²·D``, dQ ``6·``, dK/dV
    ``8·B·H·L²·D`` FLOPs (3xTF32 counted once) over the pairs attention
    computes; every input read once (a broadcast bias by what it holds),
    every output written once, the stored dropout mask left out."""
    b, h, lq, lk, d = 2, 3, 8, 8, 16
    q, k, v, bias = _attn(b, h, lq, lk, d, dtype, bias=True)
    es = q.element_size()
    pairs = lq * (lq + 1) // 2 if causal else lq * lk
    t = b * h * lq * d * es  # one [B, H, L, D] tensor
    stat = b * h * lq * 4  # one f32 [B*H, L] row statistic
    bias_bytes = b * lk * 4
    lse = torch.zeros(b * h, lq)
    fwd = flash_attention._fwd_cost(q, k, v, bias, causal, None, 0.1)
    assert fwd == (4 * b * h * pairs * d, 3 * t + bias_bytes + t + stat)
    dq = flash_attention._dq_cost(q, k, v, bias, lse, lse, q, causal)
    assert dq == (6 * b * h * pairs * d, 3 * t + 2 * stat + t + bias_bytes + t)
    dqd = flash_attention._dq_delta_cost(q, k, v, bias, lse, q, q, causal)
    assert dqd == (6 * b * h * pairs * d, 5 * t + stat + bias_bytes + t + stat)
    dkv = flash_attention._dkv_cost(q, k, v, bias, lse, lse, q, causal)
    assert dkv == (8 * b * h * pairs * d, 4 * t + 2 * stat + bias_bytes + 2 * t)


def test_attention_at_bert_shape_is_the_perf_rows():
    """PERF.md row 3b's shape: 32 x 12 heads x 512 x 64 in bf16."""
    q = torch.empty(32, 12, 512, 64, dtype=BF16, device="meta")
    flops, _ = flash_attention._fwd_cost(q, q, q, None)
    assert flops == 4 * 32 * 12 * 512 * 512 * 64


# -- compiled steps on the CPU ---------------------------------------------------------


def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))


def test_cpu_compiled_step_records_once_and_books_every_call():
    from paddle_tpu_torch.optimizer import Momentum

    model = _mlp()
    opt = Momentum(learning_rate=0.1, parameters=model.parameters())
    step = train_step(model, opt, lambda m, x, t: ((m(x) - t) ** 2).mean(), device="cpu")
    rng = np.random.RandomState(0)
    x, t = rng.randn(5, 8).astype("f4"), rng.randn(5, 4).astype("f4")
    for _ in range(3):
        step(x, t)
    recs = [r for r in cost_model.cost_records().values() if r.label == "train_step"]
    assert len(recs) == 1 and recs[0].runs == 3
    rec = recs[0]
    # forward 2·B·P for both products; backward: both weight gradients
    # (2·B·P) and the input gradient of the second product only (x needs none)
    bsz, p1, p2 = 5, 8 * 16, 16 * 4
    assert rec.flops == 2 * bsz * (p1 + p2) + 2 * bsz * (p1 + p2) + 2 * bsz * p2
    assert monitor.counter("cost/executed_flops").value == 3 * rec.flops
    assert rec.bytes_accessed > 0 and rec.argument_bytes == x.nbytes + t.nbytes
    # the momentum update ran through its wrapper: counted by row 14's formula
    assert rec.key.startswith("train_step#")


def test_cpu_eval_step_records_its_cost():
    ev = eval_step(_mlp(), device="cpu")
    x = np.ones((3, 8), "f4")
    ev(x)
    ev(x)
    (rec,) = [r for r in cost_model.cost_records().values() if r.label == "eval_step"]
    assert rec.flops == 2 * 3 * (8 * 16 + 16 * 4) and rec.runs == 2


def _bert_closed_form(cfg, batch, seq, n_pred):
    """6 x matmul parameters x tokens + 12·B·H·L²·D a layer + the MLM head on
    the masked positions (transform and the tied decoder) and the pooler
    and NSP head on the first token."""
    hdim, ff, layers, heads = (cfg.hidden_size, cfg.intermediate_size,
                               cfg.num_hidden_layers, cfg.num_attention_heads)
    tokens = batch * seq
    encoder = layers * (4 * hdim * hdim + 2 * hdim * ff)
    attention = layers * 12 * batch * heads * seq * seq * (hdim // heads)
    head = 6 * (hdim * hdim + hdim * cfg.vocab_size) * batch * n_pred
    pooled = 6 * (hdim * hdim + hdim * 2) * batch
    return 6 * encoder * tokens + attention + head + pooled


def test_tiny_bert_step_is_within_5pct_of_its_closed_form():
    from paddle_tpu_torch.models import (BertForPretraining, BertPretrainingCriterion,
                                         bert_tiny_config)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = bert_tiny_config()
    model = BertForPretraining(cfg, generator=torch.Generator().manual_seed(0))
    crit = BertPretrainingCriterion(cfg.vocab_size)
    batch, seq, n_pred = 2, 16, 4
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype("int64")
    types = np.zeros((batch, seq), "int64")
    pos = (np.arange(batch)[:, None] * seq + rng.randint(0, seq, (batch, n_pred))).reshape(-1)
    mlm = rng.randint(0, cfg.vocab_size, (batch * n_pred, 1)).astype("int64")
    nsp = rng.randint(0, 2, (batch, 1)).astype("int64")

    def loss_fn(m, ids, types, pos, mlm, nsp):
        pred, rel = m(ids, types, masked_positions=pos)
        return crit(pred, rel, mlm, nsp)

    step = train_step(model, AdamW(learning_rate=1e-4, parameters=model.parameters()),
                      loss_fn, device="cpu")
    step(ids, types, pos.astype("int64"), mlm, nsp)
    (rec,) = [r for r in cost_model.cost_records().values() if r.label == "train_step"]
    want = _bert_closed_form(cfg, batch, seq, n_pred)
    assert rec.flops == pytest.approx(want, rel=0.05), (rec.flops, want)


def test_tiny_resnet_step_is_within_5pct_of_its_closed_form():
    """3 x the forward's conv and fc FLOPs x batch."""
    from paddle_tpu_torch.models import resnet18
    from paddle_tpu_torch.nn.layers import Conv2D, Linear
    from paddle_tpu_torch.optimizer import Momentum

    model = resnet18(num_classes=10)
    batch, hw = 2, 32
    x = np.random.RandomState(0).randn(batch, 3, hw, hw).astype("f4")
    y = np.zeros((batch,), "int64")
    fwd = []

    def hook(mod, inp, out):
        w = mod.weight  # conv [Cout, Cin/groups, kh, kw]; fc [in, out]
        per_output = int(np.prod(w.shape[1:])) if w.dim() == 4 else w.shape[0]
        fwd.append(2 * out.numel() * per_output)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv2D, Linear))]
    # the layers' own forwards (the fused conv + batch norm + relu route
    # takes their weights without calling them)
    set_flags({"use_fused_conv_bn": False})
    try:
        with torch.no_grad():
            model.eval()
            model(torch.from_numpy(x))
    finally:
        set_flags({"use_fused_conv_bn": True})
    for h in handles:
        h.remove()
    if not fwd:
        pytest.fail("no conv or fc layer seen: the hook names the wrong layer types")
    opt = Momentum(learning_rate=0.1, parameters=model.parameters())
    step = train_step(model, opt,
                      lambda m, a, b: torch.nn.functional.cross_entropy(m(a), b), device="cpu")
    step(x, y)
    (rec,) = [r for r in cost_model.cost_records().values() if r.label == "train_step"]
    want = 3 * sum(fwd)
    assert rec.flops == pytest.approx(want, rel=0.05), (rec.flops, want)
