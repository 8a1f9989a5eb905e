"""The port's figures (fiode_tpu_torch/utils/plotting.py) and debug switches
(utils/debug.py): the simplex plots draw the JAX module's points and lines
for the same arrays; a 3-class training run writes its per-epoch figures;
certify_segway(plot_dir=) writes its two; without matplotlib every function
returns None and nothing is written; set_debug(nans=True) raises at a NaN
in the forward and the backward; trace writes a profiler trace."""
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from fiode_tpu.utils import plotting as jplot
from fiode_tpu_torch.experiment import build_trainer
from fiode_tpu_torch.utils import debug, plotting
from fiode_tpu_torch.utils.config import compose

REPO = Path(__file__).resolve().parents[1]
tseg = importlib.import_module("fiode_tpu_torch.control.certify_segway")


@pytest.fixture
def mpl():
    if not plotting.HAVE_MATPLOTLIB:
        pytest.skip("matplotlib is not installed")


def _simplex(seed, shape):
    e = np.random.default_rng(seed).exponential(size=shape).astype(np.float32)
    return e / e.sum(-1, keepdims=True)


def _drawn(fig):
    ax = fig.axes[0]
    return ([np.asarray(c.get_offsets()) for c in ax.collections],
            [ln.get_xydata() for ln in ax.lines])


def test_simplex_plots_draw_what_the_jax_module_draws(mpl):
    import matplotlib.pyplot as plt
    h = _simplex(0, (40, 3))
    labels = np.arange(40) % 3
    traj = _simplex(1, (7, 5, 3))
    pairs = [(jplot.plot_samples_on_3_simplex(h),
              plotting.plot_samples_on_3_simplex(torch.from_numpy(h))),
             (jplot.plot_samples_on_3_simplex(h, labels),
              plotting.plot_samples_on_3_simplex(h, torch.from_numpy(labels))),
             (jplot.plot_traj_on_3_simplex(traj, labels[:5]),
              plotting.plot_traj_on_3_simplex(torch.from_numpy(traj),
                                              labels[:5]))]
    for want, got in pairs:
        (wc, wl), (gc, gl) = _drawn(want), _drawn(got)
        assert len(wc) == len(gc) and len(wl) == len(gl) > 0
        for a, b in zip(wc + wl, gc + gl):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        plt.close(want)
        plt.close(got)


def _three_class_trainer(tmp_path):
    cfg = compose("cifar_train.yaml", [
        "+dataset=CIFAR3", "++batch_size=16", "++synthetic_size=64",
        "++val_batch_size=64", "++module.h_sample_size=4",
        "++module.dynamics.mlp_size=16", "++module.dynamics.x_dim=3",
        "+module/init_fun/param_map@module.init_fun.param_map=TinyMLP",
        "++module.init_fun.param_map.out_dim=3",
        f"++data_root={tmp_path / 'none'}"],
        str(REPO / "configs" / "classification"))
    return build_trainer(cfg, str(tmp_path / "run"), device="cpu")


def test_three_class_run_writes_its_figures(mpl, tmp_path):
    tr = _three_class_trainer(tmp_path)
    assert tr.n == 3
    state = tr.gen.get_state()
    tr._plot_simplex(7)  # the figures draw nothing from the training stream
    assert torch.equal(tr.gen.get_state(), state)
    tr.fit(epochs=1)
    names = sorted(p.name for p in (tmp_path / "run" / "plots").iterdir())
    assert names == ["samples_e0000.png", "samples_e0007.png",
                     "traj_e0000.png", "traj_e0007.png"]


def test_certify_segway_writes_its_figures(mpl, tmp_path):
    tseg.certify_segway(REPO / "run_data" / "segway" / "segway_f32.npz",
                        r=0.1, plot_dir=str(tmp_path / "p"), verbose=False,
                        device="cpu")
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == [
        "segway_traj3d.png", "segway_vdot_phase.png"]


def test_without_matplotlib_nothing_is_drawn(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(plotting, "HAVE_MATPLOTLIB", False)
    h = _simplex(0, (8, 3))
    out = tmp_path / "f.png"
    assert plotting.plot_samples_on_3_simplex(h, save=str(out)) is None
    assert plotting.plot_traj_on_3_simplex(h[None], [0] * 8, save=str(out)) is None
    assert plotting.plot_segway_traj3d(np.zeros((4, 2, 3)), save=str(out)) is None
    assert plotting.plot_segway_phase(
        None, None, phi_region=0.2, region=1.0, level=0.1, level_lb=0.05,
        level_ub=0.2, save=str(out)) is None
    assert not out.exists()
    tseg.certify_segway(REPO / "run_data" / "segway" / "segway_f32.npz",
                        r=0.1, plot_dir=str(tmp_path / "p"), device="cpu")
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert not (tmp_path / "p").exists()
    tr = _three_class_trainer(tmp_path)
    tr._plot_simplex(0)
    tr._plot_simplex(1)  # said once
    assert capsys.readouterr().err.count("matplotlib is not installed") == 1
    assert not (tmp_path / "run" / "plots").exists()


def test_set_debug_raises_at_a_nan():
    lin = torch.nn.Linear(3, 2)
    nan_in = torch.tensor([[float("nan"), 0.0, 0.0]])
    try:
        debug.set_debug(nans=True)
        with pytest.raises(debug.NonFiniteError, match="Linear"):
            lin(nan_in)
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0.0).sum().backward()
        with pytest.raises(NotImplementedError):
            debug.set_debug(checks=True)
    finally:
        debug.set_debug()
    assert torch.isnan(lin(nan_in)).any()  # off again
    assert not torch.is_anomaly_enabled()


def test_trace_and_step_timer(tmp_path):
    with debug.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    traces = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    got = []
    with debug.step_timer("x", sink=lambda n, s: got.append((n, s))):
        pass
    assert got[0][0] == "x" and got[0][1] >= 0.0
