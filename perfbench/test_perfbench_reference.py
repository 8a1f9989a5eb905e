"""The plain reference against the program's plain path at small widths on
the CPU, and the reference's isolation from the program and from JAX."""
import subprocess
import sys

import numpy as np
import torch

from perfbench import harness, weights
from perfbench.conftest import tiny_cell
from perfbench.reference import crown as ref_crown, dopri5, model as ref

SEED = 2 ** 31 + 12345


def _model(cell):
    m = harness.program_model(cell["config"], "cpu")
    shapes = {k: tuple(p.shape) for k, p in m.named_parameters()}
    params = weights.draw(shapes, harness.subseed(SEED, 0), "cpu")
    weights.load(m, params)
    return m, params


def test_the_reference_loads_nothing_of_the_program_or_of_jax():
    code = ("import sys; import perfbench.reference.model, "
            "perfbench.reference.dopri5, perfbench.reference.crown, "
            "perfbench.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"jax", "jaxlib", "flax", "fiode_tpu", "fiode_tpu_torch"}


def test_weights_from_a_large_seed_repeat():
    shapes = {"a.weight": (3, 4), "a.alpha": (), "a.bias": (3,)}
    a = weights.draw(shapes, harness.subseed(2 ** 33 + 1, 0), "cpu")
    b = weights.draw(shapes, harness.subseed(2 ** 33 + 1, 0), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert a["a.alpha"] == torch.linalg.norm(a["a.weight"])


def test_backbone_and_rhs_match_the_programs_plain_path():
    cell = tiny_cell("ode-solve-b32768")
    m, P = _model(cell)
    x = torch.rand(3, 3, 8, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        feats = m.features(x)
        assert torch.allclose(ref.backbone(P, x, cell["config"]), feats,
                              atol=1e-5, rtol=1e-5)
        p, xc = m._fused_setup(feats)
        dense = ref.dense_dynamics(P)
        assert torch.allclose(ref.injection(feats, dense), xc, atol=1e-6)
        h = torch.softmax(torch.randn(3, 10), -1)
        from fiode_tpu_torch.ops.fused_rhs import rhs_reference
        d = m.dynamics
        want = rhs_reference(h, xc, p, d.alpha_1, d.sigma_1, d.alpha_2, True,
                             d.qp_iters)
        got = ref.rhs(h, xc, dense, cell["config"], True)
        assert torch.allclose(got, want, atol=1e-5)


def test_dopri5_matches_the_programs_solve():
    cell = tiny_cell("ode-solve-b32768")
    cfg = cell["config"]
    m, P = _model(cell)
    x = torch.rand(5, 3, 8, 8, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        sol = m.solve(x)
        dense = ref.dense_dynamics(P)
        xc = ref.injection(ref.backbone(P, x, cfg), dense)
        h0 = torch.full((5, 10), 0.1)
        y, nfe, att = dopri5.solve(
            lambda t, h: ref.rhs(h, xc, dense, cfg, True), h0, cfg["t_max"],
            cfg["rtol"], cfg["atol"], cfg["max_steps"])
    assert (nfe, att) == (sol.nfe, sol.attempts)
    assert torch.allclose(y, sol.ys[-1], atol=1e-5)


def test_crown_block_matches_the_certifier():
    from fiode_tpu_torch.verify.certify import Certifier, label_perms
    cell = tiny_cell("crown-certify-t40")
    cfg = cell["config"]
    m, P = _model(cell)
    cert = Certifier(m, T=cfg["T"], eps_input=cfg["eps"], chunk=cfg["chunk"])
    assert len(cert.grid) == ref_crown.grid_count(10, cfg["T"])
    assert ref_crown.grid_faults(cert.grid, cfg["T"]) == 0
    n = cfg["img_size"]
    x = torch.rand(3, 3, n, n, generator=torch.Generator().manual_seed(3))
    labels = torch.tensor([0, 4, 9])
    etas, valids, _ = next(cert.iter_blocks(2))
    with torch.no_grad():
        xb = m.features(x) @ cert.U.T + cert.bU
        want = cert.crown_block(xb, labels, label_perms(labels, 10), etas,
                                valids, torch.full((3,), float("-inf")))
        dense = ref.dense_dynamics(P)
        Ws = [dense[k][0] for k in ("hidden_to_mlp", "mlp_to_mlp", "mlp_to_hidden")]
        bs = [dense[k][1] for k in ("hidden_to_mlp", "mlp_to_mlp", "mlp_to_hidden")]
        got = ref_crown.block_worst(Ws, bs, xb, labels, etas, valids,
                                    1.0 / cfg["T"], ref_crown.kappa(cfg), cfg)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_grid_faults_counts_every_departure():
    from fiode_tpu_torch.verify.grid import enumerate_decision_boundary
    grid = enumerate_decision_boundary(4, 6)
    assert ref_crown.grid_faults(grid, 6) == 0
    assert ref_crown.grid_faults(grid, 6, block=3) == 0
    assert ref_crown.grid_faults(grid[::-1].copy(), 6) > 0
    assert ref_crown.grid_faults(grid[:-1], 6) == 1
    bad = grid.copy()
    bad[5] = bad[4]
    assert ref_crown.grid_faults(bad, 6) == 1
    bad = grid.copy()
    bad[3, 0] += np.float32(1e-3)
    assert ref_crown.grid_faults(bad, 6) >= 1


def test_the_training_step_matches_the_trainer():
    cell = tiny_cell("lyapunov-train-b128")
    gen = harness.load_module("traffic", "train_step")
    st = gen.setup(cell, SEED, "cpu")
    st.window = {"losses": []}
    gen.release(st)
    want = gen.reference(st)
    assert np.allclose(st.answers["losses"], want["losses"], rtol=1e-5)
    for k in st.p0:
        assert torch.allclose(st.answers["g1"][k], want["g1"][k], rtol=1e-4,
                              atol=1e-6), k
        assert torch.allclose(st.answers["pk"][k], want["pk"][k], rtol=1e-4,
                              atol=1e-6), k
