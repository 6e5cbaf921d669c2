"""One rank of a port world on the CPU, over gloo, for the distributed tests.

Started by ``paddle_tpu_torch.distributed.launch.launch_procs`` (or the
launch CLI) with the rank's environment; ``python torch_dist_worker.py
SCENARIO DIR``. Each scenario prints one JSON line (one ``write``: the
ranks share the launcher's pipes) and may leave ``.npz`` files in ``DIR``:

- ``train``: ``DIR/spec.json`` names the model (``mlp`` or ``convnet``), the
  optimizer, the steps and the modes; ``DIR/weights.pdparams`` holds the
  JAX model's state dict, ``DIR/data.npz`` the global batches. Each mode
  trains a fresh copy: ``sharded`` (``parallel.sharded_train_step`` over
  ``create_mesh(dp=world)``), ``dataparallel`` (``paddle.DataParallel``'s
  eager loop on this rank's slice), ``nosync`` (the sharded step with the
  batch norms' statistics left local: the control), ``zero1`` (the
  sharded step with ``strategy.sharding``, through
  ``fleet.distributed_optimizer``), ``localsgd`` (``strategy.localsgd``
  with ``k_steps`` the step count: the replicas are averaged at the last),
  ``recompute`` and ``merge`` (``strategy.gradient_merge``, ``k_steps`` 2).
- ``collectives``: every collective of ``distributed`` on ``[rank + 1]``-
  valued tensors, and fleet's metrics.
- ``desync``: rank 1 skips one ``all_reduce``; both ranks exchange their
  tails and dump the flight recorder.
- ``clusterz``: a monitored loop (rank 1 slowed), rank 0 serves
  ``/clusterz``.
- ``checkpoint``: ZeRO-1 steps with a save and a restore at this world size
  (``DIR/ckpt.json`` says which steps, where to restore from, where to
  save to and after which step).
- ``retry_save``: a ZeRO-1 save that rank 0 gives up on while rank 1's
  commit is late (``FLAGS_fault_injection`` delays it), then another
  step and a save into the same path; each rank reports whether the
  published snapshot holds its own live leaves.
- ``mesh``: the mesh's axes, sizes and groups, and the fleet's.
- ``branches``: ``Branchy`` (a layer that a rank's loss reaches only when
  its slice asks for it, and one no loss reaches) from
  ``DIR/branchy.npz`` on ``DIR/branchy_data.npz``'s batches, trained by
  ``DataParallel`` with and without ``find_unused_parameters`` and by the
  sharded step; each rank leaves its final state in
  ``DIR/branches_<mode>_r<rank>.npz``.
"""
import contextlib
import datetime
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import torch  # noqa: E402

torch.set_num_threads(1)

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch import nn, optimizer, parallel  # noqa: E402
from paddle_tpu_torch.distributed import collective as C  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402


class MLP(nn.Layer):
    def __init__(self, d=16, c=4):
        super().__init__()
        self.fc1 = nn.Linear(d, 32)
        self.fc2 = nn.Linear(32, c)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class _OpsBatchNorm(nn.BatchNorm2D):
    """A batch norm through the op registry's ``batch_norm``
    (``ops/kernels.py``) rather than ``nn.functional``'s."""

    def forward(self, x):
        return paddle.ops.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                                     training=self.training, momentum=self.momentum,
                                     epsilon=self.epsilon)


class ConvNet(nn.Layer):
    """conv1/bn1 fused with relu, conv2/bn2 unfused (``nn.functional``),
    conv3/bn3 unfused (the op registry), pooled, a linear head."""

    def __init__(self, c=4):
        super().__init__()
        self.conv1 = nn.Conv2D(3, 8, 3, padding=1, bias_attr=False)
        self.bn1 = nn.BatchNorm2D(8)
        self.conv2 = nn.Conv2D(8, 8, 3, padding=1, bias_attr=False)
        self.bn2 = nn.BatchNorm2D(8)
        self.conv3 = nn.Conv2D(8, 8, 1, bias_attr=False)
        self.bn3 = _OpsBatchNorm(8)
        self.fc = nn.Linear(8, c)

    def forward(self, x):
        h = nn.fused_conv_bn_relu(self.conv1, self.bn1, x)
        h = F.relu(self.bn2(self.conv2(h)) + h)
        h = F.relu(self.bn3(self.conv3(h)))
        return self.fc(h.mean((2, 3)))


MODELS = {"mlp": MLP, "convnet": ConvNet}


class Branchy(nn.Layer):
    """An MLP whose ``extra`` layer runs only on a slice whose first
    feature has a positive mean (a branch each rank takes on its own data),
    and whose ``never`` layer no input reaches."""

    def __init__(self, d=16, c=4):
        super().__init__()
        self.fc1 = nn.Linear(d, 32)
        self.extra = nn.Linear(32, 32)
        self.never = nn.Linear(32, 32)
        self.fc2 = nn.Linear(32, c)

    def forward(self, x):
        h = F.relu(self.fc1(x))
        if float(x[:, 0].mean()) > 0:
            h = h + self.extra(h)
        return self.fc2(h)


def loss_fn(m, x, y):
    return F.cross_entropy(m(x), y).mean()


def _emit(obj):
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _model(spec, d):
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.framework.serialization import load

    m = MODELS[spec["model"]]()
    m.load_state_dict(convert._state_from_numpy(
        load(os.path.join(d, "weights.pdparams"), return_numpy=True), m))
    return m


def _opt(spec, m):
    kind, lr = spec["opt"], spec["lr"]
    if kind == "sgd":
        return optimizer.SGD(learning_rate=lr, parameters=m.parameters())
    if kind == "momentum":
        return optimizer.Momentum(learning_rate=lr, momentum=0.9, parameters=m.parameters())
    return optimizer.Adam(learning_rate=lr, parameters=m.parameters(),
                          grad_clip=optimizer.ClipGradByGlobalNorm(spec.get("clip", 1.0)))


@contextlib.contextmanager
def _stats_left_local():
    """The control: batch norms see only this rank's slice."""
    real = C.batch_stats_over

    @contextlib.contextmanager
    def local(group):
        with real(None) as g:
            yield g

    C.batch_stats_over = local
    try:
        yield
    finally:
        C.batch_stats_over = real


def _train_mode(mode, spec, d, X, Y):
    world, rank = paddle.distributed.get_world_size(), paddle.distributed.get_rank()
    m = _model(spec, d)
    opt = _opt(spec, m)
    out = {}
    if mode == "dataparallel":
        dp = paddle.DataParallel(m)
        n = X.shape[1] // world
        losses = []
        for s in range(spec["steps"]):
            x = torch.from_numpy(X[s, rank * n:(rank + 1) * n])
            y = torch.from_numpy(Y[s, rank * n:(rank + 1) * n])
            loss = dp.scale_loss(loss_fn(dp, x, y))
            loss.backward()
            dp.apply_collective_grads()
            opt.step()
            opt.clear_grad()
            g = loss.detach().clone()
            C.all_reduce(g, C.ReduceOp.AVG)
            losses.append(float(g))
    else:
        mesh = parallel.create_mesh(dp=world)
        strategy = fleet.DistributedStrategy()
        strategy.sharding = mode == "zero1"
        if mode == "localsgd":  # local steps, the replicas averaged at the last
            strategy.localsgd = True
            strategy.localsgd_configs.k_steps = spec["steps"]
        strategy.recompute = mode == "recompute"
        if mode == "merge":  # the optimizer every second call, on the mean of two
            strategy.gradient_merge = True
            strategy.gradient_merge_configs.k_steps = 2
        dopt = fleet.distributed_optimizer(opt, strategy)
        step = parallel.sharded_train_step(m, dopt, loss_fn, mesh)
        ctx = _stats_left_local() if mode == "nosync" else contextlib.nullcontext()
        with ctx:
            losses = []
            for s in range(spec["steps"]):
                losses.append(float(step(X[s], Y[s])["loss"]))
                if s == 0 and mode == "sharded" and rank == 0:  # the first step's gradients
                    np.savez(os.path.join(d, f"grads_w{world}.npz"),
                             **{n: p.grad.numpy() for n, p in m.named_parameters()})
        if mode != "localsgd":
            out["opt_state_bytes"] = step.opt_state_bytes()
        out["uncaptured"] = step.store.uncaptured
    out["losses"] = losses
    out["param_sum"] = float(sum(p.detach().double().sum() for p in m.parameters()))
    if rank == 0:
        np.savez(os.path.join(d, f"{mode}_w{world}.npz"),
                 **{k: v.detach().numpy() for k, v in m.state_dict().items()})
    return out


def train(d):
    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    data = np.load(os.path.join(d, "data.npz"))
    X, Y = data["X"], data["Y"]
    return {mode: _train_mode(mode, spec, d, X, Y) for mode in spec["modes"]}


def collectives(d):
    from paddle_tpu_torch.distributed import fleet as fl

    world, rank = paddle.distributed.get_world_size(), paddle.distributed.get_rank()
    x = lambda: torch.full((2,), float(rank + 1))  # noqa: E731
    r = {}
    r["all_reduce"] = C.all_reduce(x()).tolist()
    r["all_reduce_max"] = C.all_reduce(x(), op=C.ReduceOp.MAX).tolist()
    r["all_reduce_min"] = C.all_reduce(x(), op=C.ReduceOp.MIN).tolist()
    r["all_reduce_prod"] = C.all_reduce(x(), op=C.ReduceOp.PROD).tolist()
    r["pmean"] = C.pmean(x()).tolist()
    r["broadcast"] = C.broadcast(x(), src=world - 1).tolist()
    r["reduce"] = C.reduce(x(), dst=0).tolist()
    r["all_gather"] = C.all_gather(None, x()).tolist()
    lst = []
    C.all_gather(lst, x())
    r["all_gather_list"] = [t.tolist() for t in lst]
    r["reduce_scatter"] = C.reduce_scatter(torch.arange(2.0 * world) + rank).tolist()
    r["scatter"] = C.scatter(torch.arange(2.0 * world) * (rank + 1), src=0).tolist()
    r["alltoall"] = C.alltoall(torch.arange(2.0 * world) + 10 * rank).tolist()
    r["p2p"] = C.p2p(x(), src=0, dst=world - 1).tolist()
    r["shift"] = C.shift(x(), offset=1).tolist()
    sub = C.new_group(ranks=[0, 1])
    r["subgroup_sum"] = C.all_reduce(x(), group=sub).tolist() if rank < 2 else None
    C.barrier()
    C.wait(x())
    r["metrics"] = {"sum": fl.metrics.sum(float(rank + 1)).tolist(),
                    "max": fl.metrics.max(float(rank + 1)).tolist(),
                    "min": fl.metrics.min(float(rank + 1)).tolist(),
                    "acc": fl.metrics.acc(float(rank + 1), 4.0),
                    "auc": fl.metrics.auc(np.array([0.0, 1.0, 1.0]) * (rank == 0),
                                          np.array([1.0, 1.0, 0.0]) * (rank == 1))}
    from paddle_tpu_torch import monitor

    r["calls"] = {n: m.value for n, m in monitor.all_metrics().items()
                  if n.startswith("collective/") and n.endswith("/calls")}
    r["algo_bytes"] = {n: m.value for n, m in monitor.all_metrics().items()
                       if n.startswith("collective/") and n.endswith("/algo_bytes")}
    return r


def desync(d):
    from paddle_tpu_torch.monitor import flight_recorder as fr

    rank = paddle.distributed.get_rank()
    # a group whose calls give up after 3 s: the mismatched calls below
    # fail there instead of hanging the world
    group = C.Group(("dp",), process_group=torch.distributed.new_group(
        [0, 1], timeout=datetime.timedelta(seconds=3)))
    x = torch.ones(4)
    C.all_reduce(x, group=group)  # seq 0: both ranks, in step
    try:
        if rank == 0:
            C.all_reduce(x, group=group)  # seq 1: rank 1 skips this one
        C.all_gather(None, x, group=group)  # rank 1's seq 1
    except RuntimeError:
        pass  # the mismatch: a timeout, or a wrong answer, never a silent hang
    report = fr.exchange_and_diagnose(tag="fixture", timeout_s=60.0)
    dump = fr.dump_now(reason="fixture_desync", desync=report)
    return {"dump": dump, "divergences": report["divergences"] if report else None}


def clusterz(d):
    from urllib.request import urlopen

    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.monitor import cluster, debug_server
    from paddle_tpu_torch.monitor import flight_recorder as fr

    rank = paddle.distributed.get_rank()
    channel = fr._default_channel()
    mon = monitor.TrainingMonitor("clusterz_fixture", interval=0)
    delay = 0.12 if rank == 1 else 0.005
    for _ in range(4):
        with mon.step(examples=8):
            time.sleep(delay)
    cluster.publish(channel=channel)
    channel.set(f"ptpu/fixture/clusterz_ready/{rank}", "1")
    if rank != 0:
        channel.get("ptpu/fixture/clusterz_done", 120.0)
        return {"published": True}
    channel.get("ptpu/fixture/clusterz_ready/1", 120.0)
    srv = debug_server.DebugServer(port=0).start()
    try:
        payload = json.loads(urlopen(srv.url + "/clusterz", timeout=120).read())
    finally:
        srv.stop()
    kinds = {e["kind"] for e in fr.events()}
    channel.set("ptpu/fixture/clusterz_done", "1")
    return {"ranks": payload["ranks"], "stragglers": payload["stragglers"],
            "missing": payload["missing_ranks"], "straggler_event": "straggler_verdict" in kinds}


def checkpoint(d):
    """``DIR/ckpt.json``: {"restore": path or null, "steps": [s, ...],
    "save": path or null, "save_after": s}; ZeRO-1 steps of ``spec.json``'s
    model and optimizer."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt

    with open(os.path.join(d, "ckpt.json")) as f:
        plan = json.load(f)
    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    data = np.load(os.path.join(d, "data.npz"))
    world = paddle.distributed.get_world_size()
    m = _model(spec, d)
    strategy = fleet.DistributedStrategy()
    strategy.sharding = True
    dopt = fleet.distributed_optimizer(_opt(spec, m), strategy)
    step = parallel.sharded_train_step(m, dopt, loss_fn, parallel.create_mesh(dp=world))
    out = {"world": world, "opt_state_bytes": step.opt_state_bytes()}
    if plan["restore"]:
        out["restored_step"] = step.load_checkpoint(plan["restore"])["step"]
    out["losses"] = {}
    for s in plan["steps"]:
        out["losses"][s] = float(step(data["X"][s], data["Y"][s])["loss"])
        if plan["save"] and s == plan["save_after"]:
            step.save_checkpoint(plan["save"], step=s, async_=False)
    return out


def retry_save(d):
    from paddle_tpu_torch.distributed import checkpoint as ckpt

    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    data = np.load(os.path.join(d, "data.npz"))
    world = paddle.distributed.get_world_size()
    m = _model(spec, d)
    strategy = fleet.DistributedStrategy()
    strategy.sharding = True
    dopt = fleet.distributed_optimizer(_opt(spec, m), strategy)
    step = parallel.sharded_train_step(m, dopt, loss_fn, parallel.create_mesh(dp=world))
    path = os.path.join(d, "ck", "step_1")
    out = {}
    step(data["X"][0], data["Y"][0])
    try:
        step.save_checkpoint(path, step=0, async_=False, peer_timeout_s=1.0)
        out["first_save"] = "returned"
    except ckpt.CheckpointError:
        out["first_save"] = "CheckpointError"
    step(data["X"][1], data["Y"][1])
    step.save_checkpoint(path, step=1, async_=False)
    C.barrier()  # rank 0 has published
    flat, manifest = ckpt.load(path)
    mine = [(n, t) for n, t, _, _, writes in step.checkpoint_plan() if writes]
    out["saved_step"] = manifest["step"]
    out["own_leaves"] = len(mine)
    out["own_leaves_equal"] = all(np.array_equal(flat[n], t.detach().numpy())
                                  for n, t in mine)
    return out


def mesh(d):
    from paddle_tpu_torch.distributed import fleet as fl

    world = paddle.distributed.get_world_size()
    m = parallel.create_mesh(dp=world // 2, tp=2)
    out = {"axis_names": list(m.axis_names), "shape": m.shape,
           "dp_group_size": torch.distributed.get_world_size(m.group("dp")),
           "tp_group_size": torch.distributed.get_world_size(m.group("tp")),
           "coord": [m.coordinate("dp"), m.coordinate("tp")]}
    with parallel.mesh_scope(m):
        out["axis_size"] = [parallel.axis_size("tp"), parallel.axis_size("pp")]
        # a collective over dp alone inside the scope: dp's group, not the world
        out["dp_sum"] = C.all_reduce(torch.ones(1)).tolist()
    out["outside"] = parallel.get_mesh() is None
    try:
        parallel.create_mesh(dp=world + 1)
        out["too_big"] = None
    except ValueError as e:
        out["too_big"] = str(e)
    s = fl.DistributedStrategy()
    s.tp_degree = 2
    fl.fleet._strategy = s
    fm = fl.fleet.build_mesh()
    out["fleet_mesh"] = fm.shape
    rules = parallel.ShardingRules([(r"fc1\.weight$", parallel.PartitionSpec(None, "tp"))])
    model = MLP()
    try:
        parallel.sharded_train_step(model, optimizer.SGD(0.1, parameters=model.parameters()),
                                    loss_fn, fm, rules=rules)
        out["tp_rule"] = None
    except NotImplementedError as e:
        out["tp_rule"] = str(e)
    return out


def spawned(d):
    """``distributed.spawn``'s target: this rank's all-reduce of its rank + 1,
    written to ``DIR/spawned_<rank>.json``."""
    rank = paddle.distributed.get_rank()
    t = C.all_reduce(torch.full((1,), float(rank + 1)))
    with open(os.path.join(d, f"spawned_{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": paddle.distributed.get_world_size(),
                   "sum": float(t[0])}, f)


BRANCHY_LR, BRANCHY_DECAY = 0.1, 0.01


def branches(d):
    world, rank = paddle.distributed.get_world_size(), paddle.distributed.get_rank()
    data = np.load(os.path.join(d, "branchy_data.npz"))
    X, Y = data["X"], data["Y"]
    init = dict(np.load(os.path.join(d, "branchy.npz")))
    n = X.shape[1] // world
    out = {}
    for mode in ("dataparallel", "find_unused", "sharded"):
        m = Branchy()
        m.set_state_dict(init)
        opt = optimizer.SGD(learning_rate=BRANCHY_LR, parameters=m.parameters(),
                            weight_decay=BRANCHY_DECAY)
        losses = []
        if mode == "sharded":
            step = parallel.sharded_train_step(m, opt, loss_fn, parallel.create_mesh(dp=world))
            losses = [float(step(X[s], Y[s])["loss"]) for s in range(len(X))]
            out["sharded_frozen"] = sorted(step._unused)
        else:
            dp = paddle.DataParallel(m, find_unused_parameters=mode == "find_unused")
            for s in range(len(X)):
                x = torch.from_numpy(X[s, rank * n:(rank + 1) * n])
                y = torch.from_numpy(Y[s, rank * n:(rank + 1) * n])
                loss = loss_fn(dp, x, y)
                loss.backward()
                dp.apply_collective_grads()
                if s == 0:
                    out[f"{mode}_no_grad"] = sorted(k for k, p in m.named_parameters()
                                                    if p.grad is None)
                opt.step()
                opt.clear_grad()
                g = loss.detach().clone()
                C.all_reduce(g, C.ReduceOp.AVG)
                losses.append(float(g))
        out[mode] = losses
        np.savez(os.path.join(d, f"branches_{mode}_r{rank}.npz"),
                 **{k: v.detach().numpy() for k, v in m.state_dict().items()})
    return out


def run_check(d):
    """``utils.run_check`` in this world: its printed lines (the sharded
    branch runs in a world above one)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        paddle.utils.run_check(device="cpu")
    return {"run_check": buf.getvalue().splitlines()}


SCENARIOS = {"train": train, "collectives": collectives, "desync": desync,
             "clusterz": clusterz, "checkpoint": checkpoint, "retry_save": retry_save,
             "mesh": mesh,
             "branches": branches, "run_check": run_check}


def main():
    scenarios, d = sys.argv[1], sys.argv[2]
    paddle.set_device("cpu")
    fleet.init(is_collective=True)
    out = {}
    for scenario in scenarios.split("+"):  # "a+b": both, in one world
        out.update(SCENARIOS[scenario](d))
    _emit({"rank": fleet.worker_index(), "world": fleet.worker_num(), **out})
    if scenarios != "desync":  # its timed-out group cannot be torn down cleanly
        paddle.distributed.env.destroy_parallel_env()


if __name__ == "__main__":
    main()
