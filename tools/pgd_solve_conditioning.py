#!/usr/bin/env python3
"""How well float32 determines the input gradient that PGD follows through
the adaptive solve, in the JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python tools/pgd_solve_conditioning.py

The model and images are those of tests/test_torch_train_modes.py's
``val_adv`` case (TinyMLP on 16 synthetic MNIST images, JAX's init carried
into the port, dopri5 at rtol = atol = 1e-3).  For each t_max it takes the
gradient of the summed cross-entropy of the solved probabilities in x: JAX
in float32 (the scan-mode solve that ``val_adv`` differentiates), the port
in float32, and JAX in float64 as the reference.  Prints one line per t_max:
the solve's accepted steps, how many images have a nonzero gradient, and
each float32 gradient's largest per-image relative distance to float64 and
to the other package's.
"""
from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from fiode_tpu.train.data import load_dataset  # noqa: E402
from fiode_tpu_torch.bridge import params_from_numpy  # noqa: E402
from test_torch_train_modes import _models  # noqa: E402

T_MAXES = (0.1, 0.2, 0.3, 1.0)


def jax_grad(jm, params, x, y):
    def ce(xa):
        s = jm.solve(params, xa, mode="scan", scale_nominal=True)
        p = jm.output_fn(s.ys[-1], params.get("output"))
        p_y = jnp.take_along_axis(jnp.clip(p, 1e-12), y[:, None], axis=-1)[:, 0]
        return jnp.sum(-jnp.log(p_y))
    return np.asarray(jax.grad(ce)(x), np.float64)


def port_grad(tm, x, y):
    xt = torch.from_numpy(x).requires_grad_()
    sol = tm.solve(xt, scale_nominal=True)
    p = tm.output_fn(sol.ys[-1])
    p_y = torch.take_along_dim(torch.clamp(p, min=1e-12),
                               torch.from_numpy(y).long()[:, None], dim=-1)
    (-torch.log(p_y)).sum().backward()
    return xt.grad.double().numpy(), sol.n_accepted


def rel(a, b):
    """Largest per-image |a - b| / |b| over the images where b is nonzero."""
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    nb = np.linalg.norm(b, axis=1)
    keep = nb > 0
    return float((np.linalg.norm(a - b, axis=1)[keep] / nb[keep]).max())


def main():
    with tempfile.TemporaryDirectory() as nodata:
        ds = load_dataset("MNIST", data_root=nodata, synthetic_size=64)
    x, y = ds.train_x[8:24], ds.train_y[8:24]
    for t_max in T_MAXES:
        jm, tm = _models(t_max=t_max)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
        params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, params))
        g32 = jax_grad(jm, params, jnp.asarray(x), jnp.asarray(y))
        gt, steps = port_grad(tm, x, y)
        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)
            g64 = jax_grad(jm, p64, jnp.asarray(x, jnp.float64), jnp.asarray(y))
        moved = int((np.abs(g64.reshape(len(x), -1)).max(axis=1) > 0).sum())
        print(f"t_max {t_max:g}: {steps} accepted steps, {moved}/{len(x)} images "
              f"with a gradient | per image, largest relative distance: JAX f32 "
              f"to f64 {rel(g32, g64):.2e}, port f32 to f64 {rel(gt, g64):.2e}, "
              f"port to JAX f32 {rel(gt, g32):.2e}")


if __name__ == "__main__":
    main()
