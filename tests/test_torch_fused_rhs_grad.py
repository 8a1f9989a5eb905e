"""Port parity for the fused RHS backward (kernel K2's module): the plain
version ``rhs_vjp_reference`` and autograd through ``fused_rhs`` on the CPU
against the JAX K2 Pallas kernel in interpret mode and against ``jax.vjp``
of the JAX reference (scale_nominal off and on), at a ragged batch (B = 37,
not a multiple of the Pallas block).  The CUDA kernel is held against the plain version in
test_torch_kernels_cuda.py."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu_torch.ops.fused_rhs import (
    RhsParams,
    fused_rhs,
    fused_rhs_vjp,
    pack_rhs_params,
    rhs_vjp_reference,
)
from fiode_tpu_torch.utils.tracing import counters

jf = importlib.import_module("fiode_tpu.ops.fused_rhs")

# the K2 tolerance of the JAX package's own test (tests/test_fused_rhs.py)
TOL = 1e-4
A1, S1, A2 = 100.0, 0.02, 20.0
B, N, MLP = 37, 10, 32


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    h = rng.uniform(size=(B, N))
    h = h / h.sum(-1, keepdims=True)
    arrs = dict(
        h=h, xc=0.5 * rng.normal(size=(B, MLP)), g=rng.normal(size=(B, N)),
        W1=0.3 * rng.normal(size=(MLP, N)), W2=0.3 * rng.normal(size=(MLP, MLP)),
        W3=0.3 * rng.normal(size=(N, MLP)), b2=0.1 * rng.normal(size=MLP),
        b3=0.1 * rng.normal(size=N),
    )
    return {k: f32(v) for k, v in arrs.items()}


def _jax_padded(a):
    lane = jf.LANE
    p = jf.pack_rhs_params(*(jnp.asarray(a[k])
                             for k in ("W1", "W2", "W3", "b2", "b3")))
    pad = lambda v: jnp.zeros((B, lane)).at[:, :v.shape[1]].set(v)  # noqa: E731
    return pad(a["h"]), pad(a["xc"]), pad(a["g"]), p


def _unpad(dh, dxc, dW1, dW2, dW3, db2, db3):
    return [np.asarray(v) for v in (dh[:, :N], dxc[:, :MLP], dW1[:MLP, :N],
                                    dW2[:MLP, :MLP], dW3[:N, :MLP],
                                    db2[:MLP], db3[:N])]


def _jax_pallas_interpret(a):
    h, xc, g, p = _jax_padded(a)
    bwd = jf._make_pallas_backward(N, A1, S1, 30, block=16, interpret=True)
    dh, dxc, dW1, dW2, dW3, db2, db3 = jax.jit(bwd)(h, xc, g, p)
    return _unpad(dh, dxc, dW1, dW2, dW3, db2[0], db3[0])


def _jax_vjp(a, scale_nominal=False):
    h, xc, g, p = _jax_padded(a)
    _, vjp = jax.vjp(
        lambda h, xc, pp: jf.rhs_reference(h, xc, pp, N, A1, S1, A2,
                                           scale_nominal, 30),
        h, xc, p)
    dh, dxc, dp = vjp(g)
    return _unpad(dh, dxc, dp.W1, dp.W2, dp.W3, dp.b2, dp.b3)


def _torch(a):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    p = pack_rhs_params(t["W1"], t["W2"], t["W3"], t["b2"], t["b3"])
    return t["h"], t["xc"], t["g"], p


def _flat(dh, dxc, dp):
    return [v.detach().numpy() for v in (dh, dxc, *dp)]


@pytest.fixture(scope="module", params=[0, 1])
def case(request):
    a = _inputs(request.param)
    return a, _jax_pallas_interpret(a), _jax_vjp(a)


def _assert_all_close(got, want):
    names = ("dh", "dxc", "dW1", "dW2", "dW3", "db2", "db3")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=TOL, err_msg=name)


def test_vjp_reference_matches_pallas_backward_interpret(case):
    a, pallas, _ = case
    h, xc, g, p = _torch(a)
    _assert_all_close(
        _flat(*rhs_vjp_reference(h, xc, g, p, A1, S1, A2, False, 30)), pallas)


def test_vjp_reference_matches_jax_vjp(case):
    a, _, want = case
    h, xc, g, p = _torch(a)
    _assert_all_close(
        _flat(*rhs_vjp_reference(h, xc, g, p, A1, S1, A2, False, 30)), want)


def test_autograd_through_fused_rhs_matches_jax(case):
    a, pallas, want = case
    h, xc, g, p = _torch(a)
    leaves = [t.clone().requires_grad_() for t in (h, xc, *p)]
    out = fused_rhs(leaves[0], leaves[1], RhsParams(*leaves[2:]), A1, S1, A2,
                    False, 30)
    grads = torch.autograd.grad(out, leaves, g)
    got = [v.numpy() for v in grads]
    _assert_all_close(got, want)
    _assert_all_close(got, pallas)


@pytest.mark.parametrize("seed", [0, 1])
def test_vjp_reference_scale_nominal_matches_jax_vjp(seed):
    # the chain through the squash f = (u - l) sigmoid(f~) + l, which K2
    # follows on CUDA; JAX differentiates its reference (no Pallas backward)
    a = _inputs(seed)
    h, xc, g, p = _torch(a)
    got = _flat(*rhs_vjp_reference(h, xc, g, p, A1, S1, A2, True, 30))
    _assert_all_close(got, _jax_vjp(a, scale_nominal=True))
    # the squash changes the result: this is not the scale_nominal-off VJP
    off = _flat(*rhs_vjp_reference(h, xc, g, p, A1, S1, A2, False, 30))
    assert np.abs(got[0] - off[0]).max() > 10 * TOL


def test_autograd_through_scale_nominal_fused_rhs_matches_reference():
    a = _inputs(3)
    h, xc, g, p = _torch(a)
    leaves = [t.clone().requires_grad_() for t in (h, xc, *p)]
    out = fused_rhs(leaves[0], leaves[1], RhsParams(*leaves[2:]), A1, S1, A2,
                    True, 30)
    got = [v.numpy() for v in torch.autograd.grad(out, leaves, g)]
    want = _flat(*rhs_vjp_reference(h, xc, g, p, A1, S1, A2, True, 30))
    _assert_all_close(got, want)


def test_cpu_vjp_wrapper_takes_the_plain_version():
    a = _inputs(2)
    h, xc, g, p = _torch(a)
    before = counters().get("k2.launches", 0)
    dh, dxc, dp = fused_rhs_vjp(h, xc, g, p, A1, S1, A2, False, 30)
    rh, rxc, rp = rhs_vjp_reference(h, xc, g, p, A1, S1, A2, False, 30)
    assert counters().get("k2.launches", 0) == before
    for got, want in zip((dh, dxc, *dp), (rh, rxc, *rp)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    dh2, dxc2, none = fused_rhs_vjp(h, xc, g, p, A1, S1, A2, False, 30,
                                    weight_grads=False)
    assert none is None
    np.testing.assert_array_equal(dh2.numpy(), dh.numpy())
    np.testing.assert_array_equal(dxc2.numpy(), dxc.numpy())
