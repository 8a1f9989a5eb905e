"""The port's two benchmark programs (fiode_tpu_torch/bench.py and
bench_certify.py, the counterparts of bench.py and bench_certify.py) on the
CPU at tiny sizes: the timed call of the solve bench gives the JAX model's
NFE and endpoints on the same perturbed inputs; the certification bench
draws the JAX bench's inputs bit for bit and its sweep gives the JAX
package's worst values; the constants copied from the JAX benches equal
theirs; the work counted from shapes equals a hand count (and, for CROWN,
the products torch's flop counter sees); without a card both programs exit
non-zero and print no record; neither imports JAX."""
import ast
import math
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import bench as jax_bench
import bench_certify as jax_bench_certify
from fiode_tpu.ops.simplex_qp import qp_method_from_env
from fiode_tpu.verify.crown import crown_mlp_bounds as jax_crown
from fiode_tpu.verify.ibp_qp import ibp_cbf_qp as jax_ibp_cbf_qp
from fiode_tpu.verify.ibp_qp import worst_case_vdot as jax_worst_case_vdot
from fiode_tpu_torch import bench, bench_certify, params_from_numpy
from fiode_tpu_torch.entry import _flagship_dynamics, flagship
from fiode_tpu_torch.models.backbones import TinyMLPBackbone
from fiode_tpu_torch.models.ivp import NeuralODEClassifier
from test_torch_refine import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
ENDPOINT_TOL = 1e-3  # the solve endpoint, as tests/test_fused_rhs.py
WORST_TOL = 1e-5
TINY_BATCH, TINY_INNER = 4, 2
SWEEP_CHUNK, SWEEP_STEPS = 256, 2


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX flagship with its TinyMLP backbone (the dry run's model),
    initialised by JAX, and the port's same model with those parameters."""
    jmodel = __graft_entry__._flagship(tiny=True)
    x = bench.images(0, TINY_BATCH, "cpu").numpy()
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    backbone = TinyMLPBackbone(3 * 32 * 32, out_dim=10, hidden=32,
                               mu=(0.485, 0.456, 0.406), std=(0.225, 0.225, 0.225))
    tmodel = NeuralODEClassifier(backbone, _flagship_dynamics(None), t_max=1.0,
                                 rtol=1e-3, atol=1e-3).eval()
    params_from_numpy(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel, x


def test_images_are_the_jax_bench_inputs():
    x = bench.images(3, 5, "cpu")
    want = np.random.default_rng(3).uniform(0, 1, (5, 3, 32, 32)).astype(np.float32)
    assert x.dtype == torch.float32 and np.array_equal(x.numpy(), want)


def test_measure_matches_the_jax_solves(tiny_pair):
    jmodel, params, tmodel, x = tiny_pair
    solve = jax.jit(lambda p, x: jmodel.solve(p, x))
    nfe, acc = 0, 0.0
    for i in range(TINY_INNER):  # bench.py: x + i.astype(float32) * 1e-5
        sol = solve(params, jnp.asarray(x) + jnp.float32(i) * 1e-5)
        assert int(sol.n_accepted) + int(sol.n_rejected) < jmodel.max_steps
        nfe += int(sol.nfe)
        acc = acc + np.asarray(sol.ys[-1])
    got = bench.measure(tmodel, torch.from_numpy(x), TINY_INNER, n_outer=1)
    assert got["nfe"] == [nfe] and len(got["call_ms"]) == 1
    np.testing.assert_allclose(got["acc"].numpy(), acc, atol=ENDPOINT_TOL)
    # bit for bit the port's own solves of the same perturbed inputs
    with torch.no_grad():
        own = sum(tmodel.solve(torch.from_numpy(x + np.float32(i) * np.float32(1e-5))).ys[-1]
                  for i in range(TINY_INNER))
    assert torch.equal(got["acc"], own)
    # the plain PyTorch version on the CPU: no kernel launches
    assert got["launches"] == {"fused_rhs": 0, "fused_rhs_backward": 0,
                               "fused_freq_apply": 0}


def test_check_and_record_on_the_cpu(tiny_pair):
    _, _, tmodel, x = tiny_pair
    xt = torch.from_numpy(x)
    check = bench.check_kernels(tmodel, xt, rows=2)
    assert check["rows"] == 2 and check["max_abs_err"] == 0.0 and check["nfe"] > 0
    result = {"call_ms": [30.0, 20.0, 40.0], "nfe": [26, 26, 28],
              "acc": torch.zeros(TINY_BATCH, 10), "launches": {}}
    flops = bench.work(tmodel)
    rec = bench.record(result, flops, xt, TINY_INNER,
                       profile={"busy_ms": 5.0, "wall_ms": 25.0, "top": []},
                       device={"name": "card", "power_limit_w": 700.0, "line": ""})
    value = 26 * TINY_BATCH / 0.020
    assert rec["metric"] == bench.METRIC and rec["unit"] == bench.UNIT
    assert math.isclose(rec["value"], value)
    assert math.isclose(rec["vs_baseline"], value / 150_000)
    assert (rec["best_ms"], rec["median_ms"], rec["nfe_total"]) == (20.0, 30.0, 26)
    program = TINY_INNER * TINY_BATCH * flops["per_image"] + 26 * TINY_BATCH * 38_788
    assert math.isclose(rec["program_tflops"], program / 1e12)
    assert math.isclose(rec["mfu"], program / 0.020 / 495e12)
    assert rec["peak_flops"] == 495e12 and rec["bound"] in ("operations", "bytes")
    assert math.isclose(rec["device_busy_ms_per_solve"], 2.5)
    assert math.isclose(rec["device_busy_frac"], 0.25)
    assert rec["device"] == {"name": "card", "power_limit_w": 700.0}


def test_a_solve_that_uses_up_its_steps_raises(tiny_pair):
    _, _, tmodel, x = tiny_pair
    tmodel.max_steps = 2
    try:
        with pytest.raises(RuntimeError, match="whole step budget"):
            bench.solve_many(tmodel, torch.from_numpy(x), 1)
    finally:
        tmodel.max_steps = 512


class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def jax_draws():
    """The arrays the JAX bench_certify hands to its compiled sweep: its
    ``_bench()`` runs until ``jax.jit(sweep).lower(...)``, which captures
    them and stops it."""
    class Jitted:
        def __init__(self, fn):
            pass

        def lower(self, *args):
            raise _Captured(args)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "jit", Jitted)
    mp.setattr(sys, "argv", ["bench_certify.py"])
    try:
        with pytest.raises(_Captured) as e:
            jax_bench_certify._bench()
    finally:
        mp.undo()
    Ws, bs, x_biases, labels, eta = e.value.args[0]
    return [np.asarray(W) for W in Ws], [np.asarray(b) for b in bs], \
        np.asarray(x_biases), np.asarray(labels), np.asarray(eta)


def test_certify_inputs_are_the_jax_bench_draws(jax_draws):
    Ws, bs, x_biases, labels, eta = jax_draws
    got = bench_certify.inputs(0, "cpu")
    for a, b in zip(got["Ws"] + got["bs"], Ws + bs):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b)
    assert np.array_equal(got["x_biases"].numpy(), x_biases)
    assert np.array_equal(got["eta"].numpy(), eta)
    assert got["labels"].tolist() == labels.tolist()


def test_certify_sweep_matches_jax(jax_draws):
    Ws, bs, x_biases, labels, eta = jax_draws
    eta = eta[:SWEEP_CHUNK]
    eps, m = bench_certify.EPS, x_biases.shape[1]

    def one(x_bias, label, e):  # the JAX bench's per-image sweep body
        xr = jnp.broadcast_to(x_bias, (e.shape[0], m))
        lb, ub = jax_crown(Ws, bs, e, eps, xr)
        f_lb, f_ub = jax_ibp_cbf_qp(e, eps, lb, ub, 100.0, 0.02, 20.0)
        return jnp.max(jax_worst_case_vdot(e, eps, f_lb, f_ub, label))

    with jax.default_matmul_precision("float32"):
        chunk = jax.jit(jax.vmap(one, in_axes=(0, 0, None)))
        want = np.full(len(labels), -np.inf, np.float32)
        for i in range(SWEEP_STEPS):
            e = jnp.asarray(eta) + jnp.float32(i) * 1e-6
            want = np.maximum(want, np.asarray(chunk(x_biases, labels, e)))
    def t(a):
        return torch.from_numpy(np.array(a))

    got = bench_certify.sweep([t(W) for W in Ws], [t(b) for b in bs],
                              t(x_biases), t(labels).long(), t(eta), SWEEP_STEPS)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WORST_TOL)


def test_certify_timing_record_and_tf32(jax_draws):
    inp = bench_certify.inputs(0, "cpu", n_images=2, chunk=16)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        tf32 = bench_certify.tf32_check(inp)
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) = saved
    assert tf32 == {"inside": [[False, False]], "after": [True, True]}
    assert after == (False, False)
    result = bench_certify.measure(inp, n_inner=2, n_outer=2)
    assert len(result["call_ms"]) == 2 and np.isfinite(result["worst"]).all()
    rec = bench_certify.record(result, inp, 2, busy_ms=0.0, tf32=tf32,
                               device={"name": "card", "power_limit_w": None})
    cells = 2 * 16 * 2
    dt = min(result["call_ms"]) / 1e3
    assert rec["metric"] == bench_certify.METRIC and rec["unit"] == bench_certify.UNIT
    assert math.isclose(rec["value"], cells / dt)
    assert math.isclose(rec["vs_baseline"], cells / dt / 50_000)
    assert rec["flops_per_cell"] == 1_484_256 and rec["peak_flops"] == 67e12
    assert math.isclose(rec["mfu"], cells * 1_484_256 / dt / 67e12)
    assert rec["device_busy_frac"] is None  # the profiler saw no device time
    assert rec["tf32"] == tf32 and rec["device"] == {"name": "card", "power_limit_w": None}
    # a non-finite worst value raises
    inp["x_biases"][0, 0] = float("nan")
    with pytest.raises(RuntimeError, match="not finite"):
        bench_certify.measure(inp, n_inner=1, n_outer=1)


def _json_dumps_dict(module) -> dict:
    """The keys and value nodes of the dict a JAX bench prints."""
    for node in ast.walk(ast.parse(Path(module.__file__).read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value: v for k, v in zip(node.args[0].keys, node.args[0].values)
                    if isinstance(k, ast.Constant)}
    raise AssertionError("no json.dumps of a dict literal")


@pytest.mark.parametrize("ours, twin, consts", [
    (bench, jax_bench, ("REF_SAMPLE_NFE_PER_SEC", "BATCH", "N_INNER", "N_OUTER")),
    (bench_certify, jax_bench_certify,
     ("REF_CELLS_PER_SEC", "CHUNK", "N_IMAGES", "N_INNER", "N_OUTER")),
])
def test_copied_constants_equal_the_jax_benches(ours, twin, consts, monkeypatch):
    for name in consts:
        assert getattr(ours, name) == getattr(twin, name), name
    printed = _json_dumps_dict(twin)
    assert printed["metric"].value == ours.METRIC
    # the unit; bench_certify's names the precision, float32 in the port
    unit = eval(compile(ast.Expression(printed["unit"]), "<unit>", "eval"),
                {"precision": "float32"})
    assert unit == ours.UNIT
    monkeypatch.delenv("FIODE_QP_METHOD", raising=False)
    monkeypatch.delenv("FIODE_QP_EXACT", raising=False)
    assert ours.QP_METHOD == qp_method_from_env() == "bisect"
    # the perturbation of a timed call's i-th solve or chunk
    src = Path(twin.__file__).read_text()
    steps = re.findall(r"i\.astype\(jnp\.float32\)\s*\*\s*([0-9.e-]+)", src)
    assert [float(v) for v in steps] == [ours.PERTURB if ours is bench else ours.STEP]
    if ours is bench_certify:
        assert "eps = 1.0 / 40" in src and ours.EPS == 1.0 / 40


def test_flagship_work_is_the_hand_count():
    model = flagship(generator=torch.Generator().manual_seed(0), device="cpu")
    # the four Cayley conv mixes: 8 F co ci, F = n (n / 2 + 1), (ci, co, n)
    # after space_to_depth for the strided ones
    conv = (8 * (32 * 17) * 32 * 3 + 8 * (16 * 9) * 32 * 128
            + 8 * (16 * 9) * 64 * 32 + 8 * (8 * 5) * 64 * 256)
    linear = 2 * 4096 * 512 + 2 * 512 * 512 + 2 * 512 * 10
    inject = 2 * 10 * 128
    rhs = (2 * 10 * 128 + 2 * 128 * 128 + 2 * 128 * 10) + 3 * 10 * 30
    assert conv == 12_738_560 and linear == 4_728_832 and rhs == 38_788
    got = bench.work(model)
    assert got["per_image"] == conv + linear + inject == 17_469_952
    assert got["per_sample_nfe"] == rhs
    assert got["param_bytes"] == 4 * sum(p.numel() for p in model.parameters())


def test_crown_work_is_what_the_flop_counter_sees():
    from torch.utils.flop_counter import FlopCounterMode
    n, m = bench_certify.N, bench_certify.M
    hand = 30 * n * m + 4 * m * m + 8 * n * m * m + 4 * n * n * m + 4 * n * n
    assert hand == 1_466_256
    assert bench_certify.flops_per_cell() == {"products": hand,
                                              "bisection": 2 * n * 3 * n * 30}
    inp = bench_certify.inputs(0, "cpu", n_images=2, chunk=8)
    rows = 2 * 8
    e = inp["eta"].repeat(2, 1)
    x_rows = inp["x_biases"].repeat_interleave(8, 0)
    with FlopCounterMode(display=False) as counter:
        bench_certify.crown_mlp_bounds(inp["Ws"], inp["bs"], e, bench_certify.EPS,
                                       x_rows)
    assert counter.get_total_flops() == rows * hand


@pytest.mark.parametrize("mod", [bench, bench_certify])
def test_main_without_a_card_exits_without_a_record(mod, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
    assert not [ln for ln in capsys.readouterr().out.splitlines()
                if ln.lstrip().startswith("{")]


def test_bench_programs_import_without_jax():
    code = ("import importlib, sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'fiode_tpu',\n"
            "          'bench', 'bench_certify', '__graft_entry__'):\n"
            "    sys.modules[m] = None\n"
            "for m in ('fiode_tpu_torch.bench', 'fiode_tpu_torch.bench_certify',\n"
            "          'fiode_tpu_torch._bench_common'):\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
