"""Local grid refinement for the Lipschitz certificate (counterpart of
``fiode_tpu/verify/refine_lips.py``, on one device).

The Lipschitz certificate adds one global grid-gap slack
sqrt(2) Lf_eta sqrt(n)/T to the exact Vdot at every lattice point; a cell
whose exact value passes but whose slack pushes it over can be closed by
covering its region with smaller boxes, each with its own smaller slack.
The branch and bound of ``verify/refine.py`` does the splitting.

Per sub-box [c - e, c + e] the certified bound is

    Vdot(eta) <= -f_y(c) + max_{w in P} f_w(c)
                 + sqrt(2) Lf_eta(box) ||e||_2 + kappa_lips

for every decision-boundary point eta in the box, where P holds every wrong
class that can be the max-wrong coordinate of some point of the box
(hi_w >= max_w' lo_w') and Lf_eta takes eta_ub = max_i(c_i + e_i).  The base
certificate covers the L-inf ball of radius 1/T around each lattice point
(its slack radius sqrt(n)/T), so the frontier starts from those balls.  A
box that provably holds no decision-boundary point (the simplex sum out of
reach, a coordinate that cannot be >= 0, or the label unable to tie the max
wrong) is vacuous (-inf).  The certificate is strict (< 0): a box value of
exactly 0 stays open, as does NaN.

An image with an exact lattice violation (the larger-T certificate fails)
cannot be refined: boxes shrinking around that point converge to the
violated exact value.  It is recorded as ``gave_up="exact_violation"``
without work.

The field at the box centres is ``Certifier.exact_field``: kernel K1 for
ReLU dynamics, the dynamics' ``eval_dot`` for GroupSort.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from .certify import float32_matmuls
from .refine import RefineStats, _bab, _images, _label_blocks, _todo

__all__ = ["refine_lips_uncertified"]


def _lips_kernels(cert):
    """``sweep_fn(cells, img)``: the base sweep's per-cell value (exact-tie
    runner, global grid-gap slack, kappa_lips), as the Certifier's Lipschitz
    block computes it before its max; ``step_fn(centres, half_widths, img)``:
    the per-box bound of the module docstring and the split dim from its
    gradient in the half-widths."""
    a1, s1, n = cert.alpha_1, cert.sigma_1, cert.n
    kappa, eps0 = cert.kappa_lips, cert.eps
    dist0 = math.sqrt(n) / cert.T
    sqrt_n = math.sqrt(n)

    def f_eval(eta_c, img):
        R = eta_c.shape[0]
        return cert.exact_field(img.p, img.field_in.expand(R, -1).contiguous(),
                                eta_c)

    def sweep_fn(eta_l, img):
        f = f_eval(eta_l, img)
        onehot = torch.arange(n, device=eta_l.device) == img.label
        wrong = torch.where(onehot, -math.inf, eta_l)
        max_wrong = wrong.amax(-1, keepdim=True)
        runner = (eta_l == max_wrong) & ~onehot
        f_y = torch.where(onehot, f, 0.0).sum(-1)
        f_w = torch.where(runner, f, -math.inf).amax(-1)
        eta_ub = eta_l.amax(-1) + eps0
        lf_eta = sqrt_n * (s1 * a1 * torch.exp(s1 * eta_ub)) + 1.0
        return -f_y + f_w + math.sqrt(2.0) * lf_eta * dist0 + kappa

    def box_val(eta_c, eps, f, label):
        onehot = torch.arange(n, device=eta_c.device) == label
        lo, hi = eta_c - eps, eta_c + eps
        wrong_lo = torch.where(onehot, -math.inf, lo)
        wrong_hi = torch.where(onehot, -math.inf, hi)
        max_wrong_lo = wrong_lo.amax(-1, keepdim=True)
        # P: wrong classes that can be the box's max-wrong coordinate
        possible = (wrong_hi >= max_wrong_lo) & ~onehot
        f_y = torch.where(onehot, f, 0.0).sum(-1)
        f_w = torch.where(possible, f, -math.inf).amax(-1)
        eta_ub = hi.amax(-1)
        lf_eta = sqrt_n * (s1 * a1 * torch.exp(s1 * eta_ub)) + 1.0
        slack = math.sqrt(2.0) * lf_eta * torch.sqrt((eps * eps).sum(-1))
        v = -f_y + f_w + slack + kappa
        # vacuous boxes: no decision-boundary point can lie inside
        y_lo = torch.where(onehot, lo, 0.0).sum(-1)
        y_hi = torch.where(onehot, hi, 0.0).sum(-1)
        feasible = ((lo.clamp_min(0.0).sum(-1) <= 1.0)
                    & (hi.sum(-1) >= 1.0)
                    & (hi >= 0.0).all(-1)
                    & (y_hi >= max_wrong_lo[:, 0])
                    & (y_lo <= wrong_hi.amax(-1)))
        v = torch.where(feasible, v, -math.inf)
        # strict certificate: exactly 0 stays open (NaN too, in _bab)
        return torch.where(v < 0.0, v, torch.maximum(v, v.new_tensor(1e-30)))

    def step_fn(c, e, img):
        # the centre value does not depend on the half-widths: the
        # gradient flows through the slack, eta_ub and the masks only
        f = f_eval(c, img)
        with torch.enable_grad():
            e_req = e.detach().requires_grad_()
            v = box_val(c, e_req, f, img.label)
            (g,) = torch.autograd.grad(v.sum(), e_req)
        score = e * (torch.nan_to_num(g).abs() + 1e-30)
        return v.detach(), score.argmax(-1)

    return sweep_fn, step_fn


def refine_lips_uncertified(
    cert,
    images,
    labels: np.ndarray,
    certified: np.ndarray,
    *,
    exact_ok: Optional[np.ndarray] = None,
    clean: Optional[np.ndarray] = None,
    chunk: int = 8192,
    superchunk: int = 16,
    collect_cap: int = 4_000_000,
    max_rounds: int = 40,
    frontier_cap: int = 1 << 20,
    box_budget: int = 64_000_000,
    progress_every: int = 0,
    skip: Optional[np.ndarray] = None,
    on_image=None,
    device_cap: int = 1 << 25,
):
    """BaB-refine every clean-but-uncertified image of a Lipschitz sweep.

    ``certified`` is the with-slack verdict array (method "lipschitz"),
    ``exact_ok`` the larger-T one; an image with ``exact_ok`` False is
    recorded as ``gave_up="exact_violation"`` without work.  When
    ``exact_ok`` is None it is computed here by ``cert.certify(...,
    method="lipschitz")``.  The resume hooks, budgets, fail-closed NaN
    handling and covering splits are those of ``refine.refine_uncertified``.
    Returns (new_certified, [RefineStats]).
    """
    certified = np.asarray(certified).copy()
    labels = np.asarray(labels)
    if len(labels) == 0:
        return certified, []
    with torch.no_grad(), float32_matmuls():
        x, _ = cert._to_device(images, labels)
        todo = _todo(cert, x, labels, certified, clean, skip, None)
    stats = []
    if not len(todo):
        return certified, stats
    if exact_ok is None:
        exact_ok = cert.certify(images, labels, method="lipschitz",
                                early_exit=False).larger_T_certified
    exact_ok = np.asarray(exact_ok, bool)

    with torch.no_grad(), float32_matmuls():
        sweep_fn, step_fn = _lips_kernels(cert)
        image = _images(cert, x, todo)
        for k, i in enumerate(todo):
            t0 = time.time()
            if not exact_ok[i]:
                stats.append(RefineStats(int(i), -1, 0, 0, False,
                                         "exact_violation", time.time() - t0))
                if on_image:
                    on_image(stats[-1])
                continue
            img = image(k, labels[i])
            viol, n_viol, gave = [], 0, ""
            for block, nb in _label_blocks(cert, img.label, chunk, superchunk):
                vals = sweep_fn(block, img)[:nb]
                # strict certificate, NaN fails closed: only vals < 0 pass
                bad = block[:nb][~(vals < 0.0)]
                if len(bad):
                    viol.append(bad)
                    n_viol += len(bad)
                if n_viol > collect_cap:
                    gave = "collect_cap"
                    break
            if gave:
                stats.append(RefineStats(int(i), -1, 0, 0, False, gave,
                                         time.time() - t0))
            elif not n_viol:
                certified[i] = True
                stats.append(RefineStats(int(i), 0, 0, 0, True, "",
                                         time.time() - t0))
            else:
                # the frontier starts from the violated cells' covered L-inf
                # balls (the box bound there is >= the sweep's value)
                ok, rounds, boxes, gave = _bab(
                    step_fn, img, torch.cat(viol), cert.eps,
                    block=chunk * superchunk,
                    max_rounds=max_rounds, frontier_cap=frontier_cap,
                    box_budget=box_budget, device_cap=device_cap)
                if ok:
                    certified[i] = True
                stats.append(RefineStats(int(i), n_viol, rounds, boxes, ok,
                                         gave, time.time() - t0))
            if on_image:
                on_image(stats[-1])
            if progress_every and (k + 1) % progress_every == 0:
                s = stats[-1]
                done = sum(1 for st in stats if st.certified)
                print(f"[refine-lips] {k + 1}/{len(todo)} images, recovered "
                      f"{done} (last: img {i} viol={s.base_violated} "
                      f"rounds={s.rounds} boxes={s.boxes_evaluated} "
                      f"ok={s.certified}{' ' + s.gave_up if s.gave_up else ''})",
                      flush=True)
    return certified, stats
