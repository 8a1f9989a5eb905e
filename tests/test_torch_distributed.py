"""Multi-process data-parallel training (fiode_tpu_torch/parallel/
multihost.py) on a two-process gloo group on the CPU, against one process
on the global batch (mirrors tests/test_multihost.py): every process draws
the global batch's random numbers and keeps its rows, a solve in the step
takes its step control over the whole batch, the gradients are
mean-reduced before the update, so one step gives parameters equal across
the processes and equal to the one-process step within 1e-6, and the
validation metrics equal the one-process ones; the CLI's ``train
--multihost`` runs under ``torch.distributed.run``.

The parameters are compared after an SGD step.  A first Adam step moves
each parameter by lr g / (|g| + 1e-8): a gradient entry near zero whose
round-off differs between the two reductions can move it by up to 2 lr
(1.4e-4 on 3 of 196,608 entries of the backbone here), so with the
config's Adam the reduced gradients are what is held to 1e-6."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fiode_tpu_torch.parallel.multihost import (
    bootstrap_multihost, process_rows, shard_rows)

REPO = Path(__file__).resolve().parents[1]
PARAM_TOL = 1e-6
VAL_RTOL = 1e-5  # a validation solve through parameters 1e-7 apart

# one step an epoch: 16 synthetic CIFAR training images, a batch of 16
TINY = ["++batch_size=16", "++synthetic_size=16", "++val_batch_size=32",
        "++module.h_sample_size=4", "++module.dynamics.mlp_size=16",
        "+module/init_fun/param_map@module.init_fun.param_map=TinyMLP",
        "++module.init_fun.param_map.out_dim=10"]

_WORKER = r"""
import json, sys
import numpy as np
sys.path.insert(0, %(repo)r)
from fiode_tpu_torch.experiment import build_trainer
from fiode_tpu_torch.parallel.multihost import bootstrap_multihost, process_rows
from fiode_tpu_torch.utils.config import compose
rank, world = bootstrap_multihost("cpu")
cfg = compose("cifar_train.yaml", %(overrides)r, %(cfg_dir)r)
run_dir = %(run_dir)r + (f"/proc{rank}" if rank else "")
tr = build_trainer(cfg, run_dir, device="cpu")
assert tr.shard == ((rank, world) if world > 1 else None), tr.shard
tr.fit(epochs=1)
np.savez(run_dir + "/params.npz", **{k: v.detach().numpy()
         for k, v in tr.model.named_parameters()})
np.savez(run_dir + "/grads.npz", **{k: v.grad.numpy()
         for k, v in tr.model.named_parameters()})
print("RESULT", json.dumps({"rank": rank, "world": world,
                            "rows": [process_rows(16).start,
                                     process_rows(16).stop]}), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(run_dir, world, tmp_path, extra=()):
    overrides = TINY + [f"++data_root={tmp_path / 'none'}", *extra]
    code = _WORKER % dict(repo=str(REPO), overrides=overrides,
                          cfg_dir=str(REPO / "configs" / "classification"),
                          run_dir=str(run_dir))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    port = _free_port()
    for rank in range(world):
        e = dict(env)
        if world > 1:
            e.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                     WORLD_SIZE=str(world), RANK=str(rank),
                     LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=e, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
        results.append(json.loads(line[len("RESULT "):]))
    return results


def _params(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _val(run_dir):
    recs = [json.loads(ln) for ln in
            (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]
    return [r for r in recs if "validation_error" in r]


# the ode objective's solve amplifies the round-off of the backbone's
# products over 8 rows instead of 16 (features 1.4e-6 apart on the CPU):
# its one-process solve alone moves by 7.3e-6 when only the thread count
# changes, and one SGD step then moves the parameters by up to 6.5e-6; the
# step control itself is held exactly by test_odeint_over_a_process_group
ODE_PARAM_TOL = 2e-5
ODE_STATE_TOL = 1e-5


@pytest.mark.parametrize("opt,objective", [("Adam", "lyapunov"),
                                           ("SGD", "lyapunov"), ("SGD", "ode")])
def test_two_process_gloo_step_equals_one_process(tmp_path, opt, objective):
    one = tmp_path / "one"
    two = tmp_path / "two"
    extra = [f"++module.opt_name={opt}", f"++module.objective={objective}"]
    (r1,) = _run(one, 1, tmp_path, extra)
    assert r1 == {"rank": 0, "world": 1, "rows": [0, 16]}
    r2 = _run(two, 2, tmp_path, extra)
    assert sorted((r["rank"], r["world"], tuple(r["rows"])) for r in r2) == [
        (0, 2, (0, 8)), (1, 2, (8, 16))]
    for name in ("params", "grads"):
        single = _params(one / f"{name}.npz")
        rank0 = _params(two / f"{name}.npz")
        rank1 = _params(two / "proc1" / f"{name}.npz")
        assert single.keys() == rank0.keys() == rank1.keys()
        for k in single:
            # every process applies the same reduced gradient
            np.testing.assert_array_equal(rank0[k], rank1[k], err_msg=k)
            if objective == "ode" and name == "params":
                np.testing.assert_allclose(rank0[k], single[k], rtol=0,
                                           atol=ODE_PARAM_TOL, err_msg=k)
            elif objective == "lyapunov" and (name == "grads" or opt == "SGD"):
                np.testing.assert_allclose(rank0[k], single[k], rtol=0,
                                           atol=PARAM_TOL, err_msg=k)
    # validation runs on the whole split in every process: equal metrics
    # across the processes, and the one-process metrics up to what the
    # parameters' difference moves through the solve
    v1, v2, v3 = _val(one), _val(two), _val(two / "proc1")
    keys = ("validation_error", "validation_loss", "simplex_min", "simplex_max")
    assert len(v1) == len(v2) == len(v3) == 1
    assert [v2[0][k] for k in keys] == [v3[0][k] for k in keys]
    assert v1[0]["validation_error"] == v2[0]["validation_error"]
    if opt == "SGD" and objective == "lyapunov":
        np.testing.assert_allclose([v1[0][k] for k in keys],
                                   [v2[0][k] for k in keys], rtol=VAL_RTOL,
                                   atol=PARAM_TOL)
    # rank 0 writes RUN/, rank 1 RUN/proc1/
    for d in (two, two / "proc1"):
        assert (d / "ckpt" / "best.npz").exists()
        assert (d / "metrics.jsonl").exists()


def test_process_rows_and_shard_rows():
    assert process_rows(8) == slice(0, 8)  # no process group: all rows
    assert process_rows(8, axis_size=4) == slice(0, 2)
    with pytest.raises(ValueError, match="not divisible"):
        process_rows(9, axis_size=2)
    g = torch.Generator().manual_seed(0)
    whole = torch.rand((6, 3), generator=g)
    for i in range(3):
        g.manual_seed(0)
        part = shard_rows(lambda m: torch.rand((m, 3), generator=g), 2, (i, 3))
        assert torch.equal(part, whole[2 * i:2 * i + 2])
    g.manual_seed(0)
    a, b = shard_rows(lambda m: (torch.rand((m,), generator=g),
                                 torch.rand((m, 2), generator=g)), 2, (1, 2))
    g.manual_seed(0)
    wa, wb = torch.rand((4,), generator=g), torch.rand((4, 2), generator=g)
    assert torch.equal(a, wa[2:]) and torch.equal(b, wb[2:])


def test_bootstrap_without_the_variables_is_one_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert bootstrap_multihost("cpu") == (0, 1)
    assert not torch.distributed.is_initialized()


def test_cli_multihost_under_torch_distributed_run(tmp_path):
    """``python -m torch.distributed.run --standalone --nproc_per_node=2 -m
    fiode_tpu_torch train --multihost --device cpu``: rank 0 writes RUN/,
    rank 1 RUN/proc1/, with equal parameters."""
    run = tmp_path / "run"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "fiode_tpu_torch", "train", "--multihost",
         "--device", "cpu", "--config-name", "cifar_train.yaml",
         "--run-dir", str(run), "--epochs", "1", *TINY,
         f"++data_root={tmp_path / 'none'}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[multihost] process 0/2" in out.stdout
    assert "[multihost] process 1/2" in out.stdout
    a = _params(run / "ckpt" / "best.npz")
    b = _params(run / "proc1" / "ckpt" / "best.npz")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


_ODE_WORKER = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, %(repo)r)
from fiode_tpu_torch.ode.integrate import odeint
from fiode_tpu_torch.parallel.multihost import bootstrap_multihost, process_rows
rank, world = bootstrap_multihost("cpu")
rows = process_rows(8)
g = np.random.default_rng(0)
# the first half of the rows is slow, the second stiff: alone, each half
# would take other steps than the whole batch
k = torch.tensor(np.concatenate([g.uniform(0.2, 1.0, (4, 3)),
                                 g.uniform(8.0, 20.0, (4, 3))]),
                 dtype=torch.float32)[rows]
y0 = torch.tensor(g.uniform(0.1, 1.0, (8, 3)), dtype=torch.float32)[rows]
k.requires_grad_()
group = torch.distributed.group.WORLD if world > 1 else None
sol = odeint(lambda t, y: -k * y + torch.sin(3.0 * t) * y * y, y0,
             [0.0, 0.5, 2.0], method=%(method)r, rtol=1e-4, atol=1e-5,
             process_group=group)
sol.ys[-1].sum().backward()
print("RESULT", json.dumps({"rank": rank, "nfe": sol.nfe,
      "acc": sol.n_accepted, "rej": sol.n_rejected,
      "ys": sol.ys.detach().tolist(), "grad": k.grad.tolist()}), flush=True)
"""


@pytest.mark.parametrize("method", ["dopri5", "dopri8"])
def test_odeint_over_a_process_group(tmp_path, method):
    """Rows of independent ODEs split over two gloo processes take the
    one-process solve's steps (its batch-global RMS step control: the same
    NFE) and its values and gradients, the gradient through the step
    control included (its all-reduce is differentiable)."""
    code = _ODE_WORKER % dict(repo=str(REPO), method=method)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"

    def run(world):
        port, procs = _free_port(), []
        for rank in range(world):
            e = dict(env)
            if world > 1:
                e.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                         WORLD_SIZE=str(world), RANK=str(rank),
                         LOCAL_RANK=str(rank))
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=e,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        out = []
        for p in procs:
            o, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in o.splitlines() if ln.startswith("RESULT ")][-1]
            out.append(json.loads(line[len("RESULT "):]))
        return sorted(out, key=lambda r: r["rank"])

    (one,), two = run(1), run(2)
    assert [(r["nfe"], r["acc"], r["rej"]) for r in two] == [
        (one["nfe"], one["acc"], one["rej"])] * 2
    ys = np.concatenate([np.asarray(r["ys"]) for r in two], axis=1)
    # the sums of squares are added in another order: error ratios an ulp
    # apart, and the step sizes after them, move the stiff rows' states by
    # up to 1.5e-6 over the solve's 60 steps
    np.testing.assert_allclose(ys, one["ys"], rtol=0, atol=ODE_STATE_TOL)
    grad = np.concatenate([np.asarray(r["grad"]) for r in two])
    np.testing.assert_allclose(grad, one["grad"], rtol=0, atol=ODE_STATE_TOL)
    # without the group each process steps its own rows otherwise
    local = subprocess.run(
        [sys.executable, "-c", code.replace("process_rows(8)", "slice(0, 4)")],
        env=env, capture_output=True, text=True, timeout=120)
    nfe_local = json.loads(local.stdout.split("RESULT ")[-1])["nfe"]
    assert nfe_local != one["nfe"]
