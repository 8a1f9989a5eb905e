"""Test settings of the benchmark's own tests (run with ``python -m pytest
perfbench``): the ``chip`` marker, for tests that need a CUDA device and
skip without one, and tiny cells for the CPU."""
import pytest

from perfbench import harness

# small enough for a CPU test: every width cut (image 8 x 8, MLP 16), the
# shapes kept; the certify cell keeps its widths, since it runs the trained
# checkpoint, cuts the grid, the chunks and the images, and checks more
# blocks (at this size a fault that drops cells changes only about half of
# the blocks' worst)
NARROW = {"img_size": 8, "mlp_size": 16}
TINY = {
    "ode-solve-b32768": ({"batch": 4, "pool": 2, "check_solves": 2}, NARROW),
    "crown-certify-t40": ({"images": 4, "check_blocks": 12},
                          {"T": 6, "chunk": 8, "superchunk": 2}),
    "lyapunov-train-b128": ({"pool": 4}, dict(NARROW, batch_size=4,
                                              h_sample_size=8)),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skips without one (run the "
        "benchmark's tests on the card: python -m pytest perfbench)")


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided here, not at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def tiny_cell(name: str) -> dict:
    """The cell ``name`` at CPU size."""
    c = harness.cell(harness.load_manifest(), name)
    mix, cfg = TINY[name]
    c["config"].update(cfg)
    c["mix"].update(mix)
    return c
