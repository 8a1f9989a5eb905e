"""Segway (wheeled inverted pendulum) dynamics, the control workload's plant
(counterpart of the JAX package's ``control/systems.py``).

  state x = (phi, v, phi_dot): tilt angle, forward velocity, tilt rate
  input u: wheel torque
  dynamics: M(phi) [v_dot, phi_ddot]^T = rhs(x, u) with the 2x2 mass matrix
      M = [[m_t,          m l cos(phi)],
           [m l cos(phi), I + m l^2   ]]
      rhs = [u / r + m l phi_dot^2 sin(phi) - c_v v,
             m g l sin(phi) - u - c_p phi_dot]
  solved in closed form (2x2 inverse); ``jacobian`` by
  ``torch.func.jacfwd``; ``simulate`` integrates the closed loop with the
  port's dopri5; ``dynamics_interval`` propagates interval bounds for
  certification.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd, vmap

from ..ode.integrate import odeint
from ..verify.interval import IV

__all__ = ["Segway"]


@dataclasses.dataclass(frozen=True)
class Segway:
    m: float = 5.0  # pendulum (body) mass [kg]
    m_w: float = 2.0  # wheel + chassis translational mass [kg]
    l: float = 0.5  # COM height [m]
    r: float = 0.2  # wheel radius [m]
    g: float = 9.81
    I_p: float = 0.45  # body inertia about the wheel axis [kg m^2]
    c_v: float = 1.0  # translational damping
    c_p: float = 0.1  # rotational damping

    @property
    def m_t(self):
        return self.m + self.m_w

    # -- open-loop dynamics --------------------------------------------------

    def __call__(self, x, u, t=0.0):
        """f(x, u): batched (N, 3), (N, 1) -> (N, 3)."""
        phi, v, phi_dot = x[..., 0], x[..., 1], x[..., 2]
        tau = u[..., 0]
        s, c = torch.sin(phi), torch.cos(phi)
        a = self.m_t
        b = self.m * self.l * c
        d = self.I_p + self.m * self.l**2
        det = a * d - b * b  # > 0 for all phi (a d > (m l)^2)
        r1 = tau / self.r + self.m * self.l * phi_dot**2 * s - self.c_v * v
        r2 = self.m * self.g * self.l * s - tau - self.c_p * phi_dot
        v_dot = (d * r1 - b * r2) / det
        phi_ddot = (-b * r1 + a * r2) / det
        return torch.stack([phi_dot, v_dot, phi_ddot], dim=-1)

    def jacobian(self, x, u, t=0.0):
        """(A, B), the batched linearisation at (x, u): (N, 3, 3), (N, 3, 1)."""
        def f(xx, uu):
            return self(xx[None], uu[None])[0]

        return vmap(jacfwd(f, argnums=(0, 1)))(x, u)

    # -- closed-loop simulation ----------------------------------------------

    def simulate(self, x0, controller, ts, method="dopri5", rtol=1e-6,
                 atol=1e-6, max_steps=100_000):
        """Integrate the closed loop from a batch of starts ``x0`` (N, 3).

        Returns (xs (T, N, 3), us (T, N, 1)) at the times ``ts``.  Raises if
        the solve attempts ``max_steps`` steps: a partial trajectory is never
        returned.  ``method`` is an adaptive one (a fixed-grid method raises
        for want of a step, as in the JAX package)."""
        def f(t, x):
            return self(x, controller(x, t))

        with torch.no_grad():
            sol = odeint(f, x0, ts, method=method, rtol=rtol, atol=atol,
                         max_steps=max_steps)
            if sol.attempts >= max_steps:
                raise RuntimeError(
                    f"simulate attempted max_steps={max_steps} steps "
                    f"({sol.n_accepted} accepted) before the last time; raise "
                    "max_steps")
            xs = sol.ys
            us = controller(xs.reshape(-1, xs.shape[-1]), 0.0)
        return xs, us.reshape(xs.shape[:-1] + (-1,))

    # -- interval bounds for certification ------------------------------------

    def dynamics_interval(self, x_iv: IV, u_iv: IV) -> IV:
        """Sound interval enclosure of f over box states and torque bounds.

        x_iv: IV of (..., 3) tensors; u_iv: IV of (..., 1) tensors.
        Returns an IV of (..., 3) tensors."""
        phi = IV(x_iv.lo[..., 0], x_iv.hi[..., 0])
        v = IV(x_iv.lo[..., 1], x_iv.hi[..., 1])
        phi_dot = IV(x_iv.lo[..., 2], x_iv.hi[..., 2])
        tau = IV(u_iv.lo[..., 0], u_iv.hi[..., 0])
        s, c = phi.sin(), phi.cos()
        a = self.m_t
        b = c * (self.m * self.l)
        d = self.I_p + self.m * self.l**2
        det = (b * b) * (-1.0) + a * d  # a d - b^2 > 0
        r1 = (tau * (1.0 / self.r) + (phi_dot.square() * s) * (self.m * self.l)
              - v * self.c_v)
        r2 = s * (self.m * self.g * self.l) - tau - phi_dot * self.c_p
        v_dot = (r1 * d - b * r2) / det
        phi_ddot = (r2 * a - b * r1) / det
        lo = torch.stack([phi_dot.lo, v_dot.lo, phi_ddot.lo], dim=-1)
        hi = torch.stack([phi_dot.hi, v_dot.hi, phi_ddot.hi], dim=-1)
        return IV(lo, hi)
