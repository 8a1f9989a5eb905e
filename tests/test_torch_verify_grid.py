"""Port parity: the decision-boundary grid (fiode_tpu_torch.verify.grid)
against the JAX package's.  Counts and enumerations are integers: they are
equal exactly, row for row; the native C++ enumeration (built with g++ at
first use) equals the pure-Python one, which is reached only by asking."""
import numpy as np
import pytest

from fiode_tpu.verify import grid as jgrid
from fiode_tpu_torch.ops import _build
from fiode_tpu_torch.verify import grid as tgrid

SIZES = [(3, 6), (4, 8), (5, 10), (10, 12)]


@pytest.mark.parametrize("n,T", SIZES)
def test_count_equals_jax(n, T):
    want = jgrid.count_decision_boundary(n, T)
    assert tgrid.count_decision_boundary(n, T) == want
    assert tgrid.count_decision_boundary(n, T, impl="python") == want


@pytest.mark.parametrize("n,T", SIZES)
def test_enumeration_equals_jax(n, T):
    want = jgrid.enumerate_decision_boundary(n, T)
    got = tgrid.enumerate_decision_boundary(n, T)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    gi = np.round(got * T).astype(int)
    np.testing.assert_array_equal(gi.sum(-1), T)
    assert (gi[:, 0] == gi[:, 1:].max(-1)).all()
    assert len({tuple(r) for r in gi}) == len(gi)


@pytest.mark.parametrize("n,T", SIZES[:3])
def test_native_equals_python(n, T):
    np.testing.assert_array_equal(
        tgrid.enumerate_decision_boundary(n, T),
        tgrid.enumerate_decision_boundary(n, T, impl="python"))


def test_full_grid_count():
    # the certification protocol's grid: n = 10, T = 40
    assert tgrid.count_decision_boundary(10, 40) == 41_320_837


@pytest.mark.parametrize("label", [0, 2, 3])
def test_grid_for_label_equals_jax(label):
    g = tgrid.enumerate_decision_boundary(4, 8)
    got = tgrid.grid_for_label(g, label)
    np.testing.assert_array_equal(got, jgrid.grid_for_label(g, label))
    gi = np.round(got * 8).astype(int)
    assert (gi[:, label] == np.delete(gi, label, axis=1).max(-1)).all()
    assert got is not g


def test_library_is_built_beside_the_cuda_ones_not_into_native():
    tgrid.count_decision_boundary(3, 6)
    libs = list(_build.BUILD_DIR.glob("libgrid_enum-*.so"))
    assert libs, "no grid_enum library under build/fiode_tpu_torch"


def test_failed_build_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    _build.load_cpp_library.cache_clear()
    tgrid._native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            tgrid.enumerate_decision_boundary(3, 6)
        # the Python enumeration is there for whoever asks for it
        assert len(tgrid.enumerate_decision_boundary(3, 6, impl="python")) == 3
    finally:
        _build.load_cpp_library.cache_clear()
        tgrid._native.cache_clear()
    with pytest.raises(ValueError):
        tgrid.enumerate_decision_boundary(3, 6, impl="numpy")
