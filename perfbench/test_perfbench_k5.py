"""The reader of K5's roofline share on a hand-made profile: its bound
from the cell's shapes, and None where the slice ran no K5 (the parent of
the change that added K5, or an untraced run)."""
import types

import pytest

from perfbench import harness, work


def read(ctx):
    return harness.load_module("metrics", "k5_roofline_pct").read(ctx)


def ctx(device_ops):
    cell = harness.cell(harness.load_manifest(), "crown-certify-t40")
    prof = harness.Profile(1, 0.0, 1000.0, device_ops, [])
    return types.SimpleNamespace(profile=prof, config=cell["config"],
                                 mix=cell["mix"])


def test_share_of_the_bound_per_launch():
    kernel = "void (anonymous namespace)::fused_cone_qp_kernel(Args)"
    c = ctx([(kernel, 0.0, 100.0), ("fused_crown_kernel", 100.0, 400.0),
             (kernel, 400.0, 500.0)])
    rows = 16 * 8192
    bound_ms = 1e3 * rows * 20 * 30 * 30 / work.FP32_FLOPS  # ops-bound
    assert rows * 240 / work.HBM_BYTES * 1e3 < bound_ms
    assert read(c) == pytest.approx(100.0 * 2 * bound_ms / 0.2)


def test_none_without_k5_or_without_a_trace():
    assert read(ctx([("fused_crown_kernel", 0.0, 300.0)])) is None
    assert read(types.SimpleNamespace(profile=None)) is None
