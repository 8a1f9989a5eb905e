"""chip_smoke.py's own helpers on the CPU: the plain path swaps the kernel
wrappers for their plain versions and raises when K1, K2 or K3 launched
inside; launches are read as deltas of the kernel wrappers' counters
under their own names; ``card()`` reads nvidia-smi's line or falls back
to the device's name; the kernel table's bounds count the same bytes and
flops as the benchmark's rooflines (perfbench/work.py), the products'
leg at the 3xTF32 rate, a third of the TF32 peak the benchmark takes; and
the script imports without JAX and without a card."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from fiode_tpu_torch.models import ivp, layers
from fiode_tpu_torch.ops.fused_rhs import rhs_reference
from fiode_tpu_torch.utils import tracing
from perfbench import harness, work

REPO = Path(__file__).resolve().parents[1]
ODE = harness.cell(harness.load_manifest(), "ode-solve-b32768")["config"]
# K1 at the flagship solve's rows: B, n, m, bisection steps
K1_SHAPE = (32768, 10, 128, 30)


def _wrappers():
    return ivp.fused_rhs, ivp.fused_rhs_vjp, layers.fused_freq_apply


def test_plain_path_swaps_the_kernel_wrappers_and_puts_them_back():
    kernels = _wrappers()
    with chip_smoke.plain_path():
        assert _wrappers() == (rhs_reference, chip_smoke.plain_rhs_vjp,
                               chip_smoke.plain_freq_apply)
    assert _wrappers() == kernels


def test_plain_path_puts_the_wrappers_back_when_its_body_raises():
    kernels = _wrappers()
    with pytest.raises(ValueError, match="inside"):
        with chip_smoke.plain_path():
            raise ValueError("inside")
    assert _wrappers() == kernels


@pytest.mark.parametrize("name", ["k1.launches", "k2.launches", "k3.launches"])
def test_plain_path_raises_when_a_solve_kernel_launched_inside(name):
    with pytest.raises(RuntimeError, match="launched a kernel"):
        with chip_smoke.plain_path():
            tracing.count(name)


def test_launched_names_each_kernel_by_its_counter_and_nothing_else():
    since = tracing.counters()
    tracing.count("k1.launches", 3)
    tracing.count("k5.launches")
    tracing.count("odeint.rejected", 2)
    assert chip_smoke.launched(since) == {
        "k1.launches": 3, "k2.launches": 0, "k3.launches": 0,
        "k4.launches": 0, "k5.launches": 1}
    assert chip_smoke.launched(since, chip_smoke.K1_K3) == {
        "k1.launches": 3, "k2.launches": 0, "k3.launches": 0}


@pytest.mark.parametrize("line,watts", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", 700.0),
    ("NVIDIA H100 80GB HBM3, [N/A]", None),
])
def test_card_reads_nvidia_smis_name_and_power_limit(monkeypatch, line, watts):
    def run(cmd, **kw):
        assert cmd[0] == "nvidia-smi"
        return subprocess.CompletedProcess(cmd, 0, stdout=line + "\n")
    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    assert chip_smoke.card() == {"name": "NVIDIA H100 80GB HBM3",
                                 "power_limit_w": watts, "line": line}


def test_card_without_nvidia_smi_names_the_device(monkeypatch):
    def run(cmd, **kw):
        raise FileNotFoundError(cmd[0])
    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "a card")
    assert chip_smoke.card() == {"name": "a card", "power_limit_w": None,
                                 "line": "a card"}


def _only(monkeypatch, leg):
    """Leave one leg of a launch's bound to count in both yardsticks:
    "bytes" at a thousandth of a byte a second (far over any flops leg),
    or "products" or "bisection" with the memory and the other unit made
    free."""
    for mod in (chip_smoke, work):
        if leg == "bytes":
            monkeypatch.setattr(mod, "HBM_BYTES", 1e-3)
            continue
        monkeypatch.setattr(mod, "HBM_BYTES", float("inf"))
        monkeypatch.setattr(mod, "TF32_FLOPS" if leg == "bisection"
                            else "FP32_FLOPS", float("inf"))


@pytest.mark.parametrize("layer", range(len(chip_smoke.CONV_SHAPES)))
def test_conv_bound_counts_the_benchmarks_work(monkeypatch, layer):
    ci, co, _, n = chip_smoke.CONV_SHAPES[layer]
    assert work.conv_shapes(ODE)[layer] == (ci, co, n)
    shape = (32768, ci, co, n)
    ms = {}
    for leg in ("bytes", "products"):
        with monkeypatch.context() as m:
            _only(m, leg)
            ms[leg] = chip_smoke.conv_bound(*shape)[0], work.conv_bound(*shape)
    # x and y once, Q once
    assert ms["bytes"][0] == ms["bytes"][1] == pytest.approx(1e6 * (
        4 * 32768 * (ci + co) * n * n + 8 * n * (n // 2 + 1) * co * ci))
    assert ms["products"][0] == pytest.approx(3 * ms["products"][1], rel=1e-12)
    assert ms["products"][1] > 0


def test_rhs_bound_counts_the_benchmarks_work_at_k1s_shape(monkeypatch):
    ms = {}
    for leg in ("bytes", "products", "bisection"):
        with monkeypatch.context() as m:
            _only(m, leg)
            ms[leg] = chip_smoke.rhs_bound(*K1_SHAPE)[0], work.rhs_bound(*K1_SHAPE)
    assert ms["bytes"][0] == ms["bytes"][1] > 0
    assert ms["bisection"][0] == ms["bisection"][1] > 0
    assert ms["products"][0] == pytest.approx(3 * ms["products"][1], rel=1e-12)
    assert ms["products"][1] > 0


def test_k4s_dense_count_is_the_benchmarks():
    n, m, qp_iters = 10, 128, 30
    assert (chip_smoke.crown_flops(n, m) + 2 * n * 3 * n * qp_iters
            == work.flops_per_cell(n, m, qp_iters))


def test_chip_smoke_imports_without_jax_and_without_a_card():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'fiode_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import torch, chip_smoke\n"
            "assert not torch.cuda.is_available()\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'fiode_tpu.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n"
            "assert callable(chip_smoke.main)\n"
            "print('ok')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
