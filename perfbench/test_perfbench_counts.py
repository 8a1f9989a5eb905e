"""The yardstick's arithmetic: the copied counts, the rates and tails over
all samples, and the profile's reduction to busy time and idle gaps."""
import pytest

from perfbench import harness, work

ODE = harness.cell(harness.load_manifest(), "ode-solve-b32768")["config"]


def test_solve_work_is_the_bench_programs_count():
    w = work.solve_work(ODE)
    assert (w["per_image"], w["per_sample_nfe"]) == (17_469_952, 38_788)


def test_flops_per_cell_is_the_certify_benchs_count():
    assert work.flops_per_cell(10, 128, 30) == 1_484_256


def test_bounds_take_the_tf32_peak():
    # K1 at the flagship's rows is bound by bytes: 19.4 MB at 3.35 TB/s
    assert work.rhs_bound(32768, 10, 128, 30) == pytest.approx(
        1e3 * (4 * 32768 * 148 + 4 * (2 * 1280 + 16384 + 138)) / 3.35e12)
    ci, co, n = work.conv_shapes(ODE)[1]
    assert (ci, co, n) == (128, 32, 16)
    F = 16 * 9
    assert work.conv_bound(4, ci, co, n) == pytest.approx(1e3 * max(
        (4 * 4 * 160 * 256 + 8 * F * 32 * 128) / 3.35e12,
        8 * 4 * F * 32 * 128 / 495e12))


def test_rate_is_all_work_over_all_time():
    assert harness.rate(300, 2.0) == 150.0
    with pytest.raises(ValueError):
        harness.rate(1, 0.0)


def test_p95_is_over_all_samples_by_nearest_rank():
    assert harness.p95(range(1, 101)) == 95.0
    assert harness.p95([5.0] * 19 + [100.0]) == 5.0
    assert harness.p95([5.0] * 18 + [100.0, 200.0]) == 100.0
    assert harness.p95([3.0]) == 3.0


def test_profile_busy_union_and_gaps():
    p = harness.Profile(2, 0.0, 100.0,
                        [("k1", 10.0, 30.0), ("k2", 20.0, 40.0),
                         ("Memcpy HtoD", 60.0, 70.0), ("k3", 95.0, 120.0)],
                        [("train.backbone", 40.0, 60.0, True),
                         ("aten::item", 0.0, 100.0, False)])
    assert p.busy_s() == pytest.approx(45e-6)
    assert p.window_s == pytest.approx(100e-6)
    assert len(p.kernels()) == 3
    assert p.device_ms(("k1", "k2")) == (pytest.approx(0.04), 2)
    b = p.breakdown()
    assert b["idle_gaps"] == [["aten::item", pytest.approx(25e-6)],
                              ["train.backbone", pytest.approx(20e-6)],
                              ["aten::item", pytest.approx(10e-6)]]
    assert b["device_ops"][0] == ["k3", pytest.approx(25e-6)]
