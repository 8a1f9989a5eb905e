"""Branch-and-bound cell refinement for the CROWN certificate (counterpart
of ``fiode_tpu/verify/refine.py``).

A positive CROWN bound on a grid cell is not a counterexample: the bound's
slack scales with the cell's box half-width.  Refinement splits such a cell
into sub-boxes that exactly cover it and bounds each again: the children's
union is the parent box and every child bound is a valid certificate over
its sub-box, so soundness is kept and only completeness improves.

Per image, the whole grid is swept again in label space at the uniform
half-width 1/T (the refined certificate does not trust the caller's
verdicts), the violated cells are collected on the device, and the frontier
of open boxes, centres (R, n) and per-dimension half-widths (R, n), stays on
the device.  Sweeps and rounds evaluate ``chunk * superchunk`` rows a call: a
sweep's call is a few launches (kernels K4 and K5 take its CROWN bounds and
interval QP), but a round's split heuristic runs the plain chains, the
interval QP's 60 bisection steps alone ~550 small launches, which at 8192
rows a call would leave the device waiting on the host.  A round bounds
every live box, keeps the open ones (``~(vals <= 0)``: a NaN bound stays open) and splits each
along its chosen dimension; its one host read is the open count.

Split heuristic: d* = argmax_d eps_d |dval/deps_d| of the plain CROWN bound,
from one ``torch.autograd.grad`` with respect to the (rows, n) half-widths
through the CROWN products and the interval QP (the box and cone
projections' closed-form VJPs).  Any split is sound; only the convergence
speed depends on the choice.  Where the gradient vanishes the score
degrades to the widest dimension.

``lips_box`` adds a second sound bound to every cell and box and takes the
elementwise minimum: the exact projected field at the box centre (kernel K1
for ReLU dynamics, through ``Certifier.exact_field``) plus the local
Lipschitz slack sqrt(2) Lf_eta ||e||_2 over the box-wide runner-up
candidates.  ``alpha_iters > 0`` bounds boxes with alpha-CROWN (never
looser than plain, every iterate sound); the base sweep stays plain CROWN
and its violated cells are filtered through the alpha bound before they
enter the frontier.

With a ``Certifier`` mesh every call's rows (base cells, frontier boxes)
are split over the certifier's cell devices (``_placed``, the JAX package's
``_row_placer`` rule: a 1-D mesh's axis, else its "cell" axis) and the
results gathered on the model's device; rows are independent, so verdicts,
violated counts and rounds are the unsharded run's.

Every sweep and round runs with TF32 off (``float32_matmuls``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .certify import float32_matmuls, label_perms
from .crown import crown_mlp_bounds, optimize_crown_alphas
from .ibp_qp import ibp_cbf_qp, ibp_sigmoid, worst_case_vdot

__all__ = ["refine_uncertified", "RefineStats", "hybrid_base_sweep",
           "SweepStats"]


@dataclasses.dataclass
class RefineStats:
    image: int
    base_violated: int  # violated cells entering BaB (post alpha filter)
    rounds: int  # BaB rounds run
    boxes_evaluated: int  # BaB sub-boxes bounded (excl. the base sweep)
    certified: bool
    gave_up: str  # "" | "collect_cap" | "frontier_cap" | "rounds" |
    #               "budget" | "time_budget" | "exact_violation"
    seconds: float
    # violated cells of the plain-CROWN sweep before the alpha-CROWN filter
    # (== base_violated when alpha_iters == 0); -2 where not recorded, so
    # records of either package parse as RefineStats(**rec)
    pre_alpha_violated: int = -2


@dataclasses.dataclass
class SweepStats:
    image: int
    worst: float  # max hybrid bound over all grid cells (NaN -> +inf)
    n_violated: int  # cells whose hybrid bound is not <= 0 (NaN counted)
    clean: bool
    certified: bool  # clean and n_violated == 0
    seconds: float


class _Image(NamedTuple):
    """One image's inputs to the box evaluators."""
    label: int
    x_bias: torch.Tensor  # (m1,): x U^T + bU, CROWN's static input
    p: object  # the exact field's weights (Certifier.rhs_rows)
    field_in: torch.Tensor  # (1, .): the exact field's per-row input


def _images(cert, x, todo):
    """Features of the images ``x[todo]`` and a function k -> _Image."""
    feats = cert.model.features(x[torch.as_tensor(todo, device=x.device)])
    x_biases = feats @ cert.U.T + cert.bU
    p, field_in = cert.rhs_rows(feats, 1)

    def image(k, label):
        return _Image(int(label), x_biases[k], p, field_in[k:k + 1])

    return image


def _placed(cert, kernels, **kw):
    """``kernels(cert, **kw)``'s (sweep_fn, step_fn) with the rows of every
    call split over ``cert.cell_devices()``: each piece runs on its
    device's copy of the certifier (``Certifier.on``) with the image's
    inputs moved there, and the results are gathered on ``cert.device``."""
    reps = [cert.on(d) for d in cert.cell_devices()]
    if len(reps) == 1 and reps[0] is cert:
        return kernels(cert, **kw)
    fns = {id(r): kernels(r, **kw) for r in reps}
    moved = {"img": None, "on": []}

    def images(img):
        # the image's inputs on each device, made once per image
        if moved["img"] is not img:
            moved["img"] = img
            moved["on"] = [img if r is cert else _Image(
                img.label, img.x_bias.to(r.device), r.field_params(),
                img.field_in.to(r.device)) for r in reps]
        return moved["on"]

    def split(which, rows, img):
        pieces = [torch.tensor_split(t, len(reps)) for t in rows]
        outs = []
        for k, (rep, rep_img) in enumerate(zip(reps, images(img))):
            part = [p[k].to(rep.device) for p in pieces]
            if len(part[0]):
                out = fns[id(rep)][which](*part, rep_img)
                outs.append(out if isinstance(out, tuple) else (out,))
        if not outs:
            out = fns[id(reps[0])][which](*rows, img)
            return out if isinstance(out, tuple) else (out,)
        return tuple(torch.cat([o[i].to(cert.device) for o in outs])
                     for i in range(len(outs[0])))

    return (lambda cells, img: split(0, (cells,), img)[0],
            lambda c, e, img: split(1, (c, e), img))


def _spacing(x: torch.Tensor) -> torch.Tensor:
    """np.spacing for positive finite float32: the gap to the next float."""
    return torch.nextafter(x, torch.full_like(x, math.inf)) - x


def _split_children(oc, oe, d):
    """Halve each box (centres ``oc``, half-widths ``oe``, (R, n)) along its
    dimension ``d`` (R,) into two covering children: (lo, hi, ce_lo, ce_hi).

    fp32 rounding of the child centres could open a sub-ulp sliver at the
    split plane or at the parent's outer edges, so each child's half-width
    in the split dimension is padded by 2 ulps at the child-centre
    magnitude: the children's union covers the parent box [c - e, c + e].
    """
    rows = torch.arange(len(oc), device=oc.device)
    half = oe[rows, d] * 0.5
    lo, hi = oc.clone(), oc.clone()
    lo[rows, d] -= half
    hi[rows, d] += half
    ce_lo, ce_hi = oe.clone(), oe.clone()
    ce_lo[rows, d] = half + 2 * _spacing(lo[rows, d].abs() + half)
    ce_hi[rows, d] = half + 2 * _spacing(hi[rows, d].abs() + half)
    return lo, hi, ce_lo, ce_hi


def _kernels(cert, alpha_iters: int = 0, lips_box: bool = False):
    """The evaluators of one Certifier's refinement pass:
    ``sweep_fn(cells, img) -> (R,)`` bounds label-space base cells at the
    uniform scalar half-width 1/T; ``step_fn(centres, half_widths, img) ->
    ((R,) values, (R,) split dims)`` bounds anisotropic boxes."""
    Ws, bs = cert.Ws, cert.bs
    a1, a2, s1 = cert.alpha_1, cert.alpha_2, cert.sigma_1
    kappa, eps0, n = cert.kappa, cert.eps, cert.n
    sqrt_n = math.sqrt(n)

    def lips_val(eta_l, eps, img):
        # exact centre + local-Lipschitz box bound; sound over the box with
        # the box-wide runner-up candidates (eta_w^ub >= max_lo)
        e = eps.expand_as(eta_l) if torch.is_tensor(eps) \
            else torch.full_like(eta_l, eps)
        R = eta_l.shape[0]
        f = cert.exact_field(img.p, img.field_in.expand(R, -1).contiguous(),
                             eta_l)
        onehot = torch.arange(n, device=eta_l.device) == img.label
        wrong_lo = torch.where(onehot, -math.inf, eta_l - e)
        max_lo = wrong_lo.amax(-1, keepdim=True)
        runner = (eta_l + e >= max_lo) & ~onehot
        f_y = torch.where(onehot, f, 0.0).sum(-1)
        f_w = torch.where(runner, f, -math.inf).amax(-1)
        eta_ub = (eta_l + e).amax(-1)
        lf_eta = sqrt_n * (s1 * a1 * torch.exp(s1 * eta_ub)) + 1.0
        dist = torch.linalg.vector_norm(e, dim=-1)
        return (-f_y + f_w) + math.sqrt(2.0) * lf_eta * dist + kappa

    def post(eta_l, eps, label, lb, ub):
        # the certificate chain after the MLP bounds: sigmoid rescale ->
        # interval QP -> worst-case Vdot
        if cert.scale_nominal:
            lb, ub = ibp_sigmoid(lb, ub, eta_l - eps, eta_l + eps, a1, s1, a2)
        f_lb, f_ub = ibp_cbf_qp(eta_l, eps, lb, ub, a1, s1, a2,
                                with_upper=cert.with_upper)
        return worst_case_vdot(eta_l, eps, f_lb, f_ub, label) + kappa

    def val(eta_l, eps, img):
        lb, ub = crown_mlp_bounds(Ws, bs, eta_l, eps, img.x_bias)
        return post(eta_l, eps, img.label, lb, ub)

    def alpha_val(eta_l, eps, img):
        # alpha-CROWN: width-surrogate gradient, the best iterate selected
        # by the certified quantity (never looser than plain)
        alphas = optimize_crown_alphas(
            Ws, bs, eta_l, eps, img.x_bias,
            loss_fn=lambda lb, ub: (ub - lb).sum(-1), iters=alpha_iters,
            select_fn=lambda lb, ub: post(eta_l, eps, img.label, lb, ub))
        lb, ub = crown_mlp_bounds(Ws, bs, eta_l, eps, img.x_bias, alphas)
        return post(eta_l, eps, img.label, lb, ub)

    def sweep_fn(cells, img):
        v = val(cells, eps0, img)
        if lips_box:
            v = torch.minimum(v, lips_val(cells, eps0, img))
        return v

    def step_fn(c, e, img):
        # the value and the split dim of each box; the split dim from the
        # gradient of the PLAIN bound in the half-widths
        with torch.enable_grad():
            e_req = e.detach().requires_grad_()
            v_plain = val(c, e_req, img)
            (g,) = torch.autograd.grad(v_plain.sum(), e_req)
        v = alpha_val(c, e, img) if alpha_iters > 0 else v_plain.detach()
        if lips_box:
            v = torch.minimum(v, lips_val(c, e, img))
        # +tiny: a vanished gradient degrades to the widest-dim split
        score = e * (torch.nan_to_num(g).abs() + 1e-30)
        return v, score.argmax(-1)

    return sweep_fn, step_fn


def _evaluate(step_fn, fc, fe, img, block):
    """``step_fn`` over all rows of a frontier, ``block`` rows a call; no
    host read."""
    vals, dims = [], []
    for i in range(0, len(fc), block):
        v, d = step_fn(fc[i:i + block], fe[i:i + block], img)
        vals.append(v)
        dims.append(d)
    return torch.cat(vals), torch.cat(dims)


def _bab(step_fn, img, centers, eps0, *, block, max_rounds, frontier_cap,
         box_budget, device_cap=1 << 25, deadline=None):
    """Frontier BaB over one image's violated cells ``centers`` (R, n), every
    box starting at the uniform half-width ``eps0``.

    The frontier stays on the device.  ``device_cap`` bounds the rows on the
    device at once: when a round's open boxes would have more children, the
    children are made a piece of the parents at a time and each piece goes
    as a sub-frontier onto a LIFO stack in host memory, to run to closure on
    its own (every open box roots an independent sub-tree); the image is
    certified iff every partition closes.  Partitioning evaluates every box
    once, as one frontier would, and keeps each box's split depth, so it
    changes no verdict short of a budget.  ``frontier_cap`` bounds the total
    live rows (the stack and the active partition), ``max_rounds`` the
    split depth of every box, and ``rounds`` counts every round run, over
    all partitions.

    Returns (closed, rounds, boxes_evaluated, gave_up)."""
    dev = centers.device
    stack = [(centers, torch.full_like(centers, eps0), max_rounds)]
    rounds = boxes = 0
    while stack:
        fc, fe, depth = stack.pop()
        fc, fe = fc.to(dev), fe.to(dev)
        if len(fc) > device_cap:
            mid = len(fc) // 2
            stack.append((fc[:mid].cpu(), fe[:mid].cpu(), depth))
            stack.append((fc[mid:].cpu(), fe[mid:].cpu(), depth))
            continue
        used = 0
        while len(fc):
            count = len(fc)
            if used >= depth:
                return False, rounds, boxes, "rounds"
            if count + sum(len(a) for a, _, _ in stack) > frontier_cap:
                return False, rounds, boxes, "frontier_cap"
            if boxes + count > box_budget:
                return False, rounds, boxes, "budget"
            if deadline is not None and time.time() > deadline:
                return False, rounds, boxes, "time_budget"
            vals, dims = _evaluate(step_fn, fc, fe, img, block)
            boxes += count
            rounds += 1
            used += 1
            # fail CLOSED on NaN: only vals <= 0 closes a box
            open_ = ~(vals <= 0.0)
            n_open = int(open_.sum())  # the round's host read
            if not n_open:
                break
            keep = torch.argsort((~open_).to(torch.uint8), stable=True)[:n_open]
            oc, oe, od = fc[keep], fe[keep], dims[keep]
            if 2 * n_open > device_cap:
                # too many children for the device: split a piece of the
                # parents at a time, each piece's children a sub-frontier
                piece = max(device_cap // 2, 1)
                for j in range(0, n_open, piece):
                    lo, hi, ce_lo, ce_hi = _split_children(
                        oc[j:j + piece], oe[j:j + piece], od[j:j + piece])
                    stack.append((torch.cat([lo, hi]).cpu(),
                                  torch.cat([ce_lo, ce_hi]).cpu(),
                                  depth - used))
                break
            lo, hi, ce_lo, ce_hi = _split_children(oc, oe, od)
            fc, fe = torch.cat([lo, hi]), torch.cat([ce_lo, ce_hi])
    return True, rounds, boxes, ""


def _label_blocks(cert, label, chunk, superchunk):
    """Yield (<= chunk superchunk, n) blocks of label-space cells over the
    grid on the device.  The tail block holds only the grid's cells: its
    padding would be bounded for nothing (a T = 8, n = 3 grid is 4 cells)."""
    perm = label_perms(torch.tensor([label], device=cert.device), cert.n)[0]
    for etas, _, n_valid in cert.iter_blocks(superchunk, chunk):
        yield etas.reshape(-1, cert.n)[:n_valid, perm]


def _todo(cert, x, labels, certified, clean, skip, order):
    if clean is None:
        clean = (cert._predict(x) == torch.as_tensor(labels, device=x.device)
                 ).cpu().numpy()
    todo_mask = np.asarray(clean, bool) & ~certified
    if skip is not None:
        todo_mask &= ~np.asarray(skip, bool)
    todo = np.nonzero(todo_mask)[0]
    if order is not None:
        # schedule in the caller's order; unlisted todo images after the
        # listed ones, in index order; repeats and non-todo entries ignored
        listed = []
        for i in np.asarray(order, int):
            if todo_mask[i] and i not in listed:
                listed.append(int(i))
        todo = np.asarray(
            listed + [int(i) for i in todo if i not in set(listed)], int)
    return todo


def refine_uncertified(
    cert,
    images,
    labels: np.ndarray,
    certified: np.ndarray,
    *,
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
    alpha_iters: int = 0,
    lips_box: bool = False,
    device_cap: int = 1 << 25,
    image_seconds: Optional[float] = None,
    order: Optional[np.ndarray] = None,
):
    """BaB-refine every clean-but-uncertified image of a CROWN sweep.

    Per image: sweep every grid cell again at the uniform half-width (on
    the device, in blocks of ``chunk * superchunk`` cells), collect the
    violated ones (NaN included), then branch and bound them until the
    frontier closes or a budget trips.  ``certified`` is not mutated; an
    updated copy is returned with images flipped True only when every
    violated cell's refinement closed.  ``RefineStats.image`` indexes into
    THIS call's ``images``.

    ``skip`` (bool mask) leaves images out of the todo set without
    certifying them (the resume hook); ``on_image(stats[-1])`` is called
    after every image; ``order`` schedules the todo images (listed first,
    in that order); ``image_seconds`` caps one image's wall clock, checked
    before each round (``gave_up="time_budget"``).  ``collect_cap`` bounds
    the violated cells collected (after the alpha filter), ``frontier_cap``
    the live boxes, ``box_budget`` the boxes bounded, ``max_rounds`` the
    split depth; ``device_cap`` the rows on the device at once (a larger
    frontier is partitioned, see ``_bab``, not abandoned).

    Returns (new_certified, [RefineStats...]).
    """
    certified = np.asarray(certified).copy()
    labels = np.asarray(labels)
    if len(labels) == 0:
        return certified, []
    with torch.no_grad(), float32_matmuls():
        x, _ = cert._to_device(images, labels)
        todo = _todo(cert, x, labels, certified, clean, skip, order)
        stats = []
        if not len(todo):
            return certified, stats
        sweep_fn, step_fn = _placed(cert, _kernels, alpha_iters=alpha_iters,
                                    lips_box=lips_box)
        image = _images(cert, x, todo)
        for k, i in enumerate(todo):
            t0 = time.time()
            img = image(k, labels[i])
            viol, n_viol, gave, pre_alpha = [], 0, "", 0
            for block in _label_blocks(cert, img.label, chunk, superchunk):
                vals = sweep_fn(block, img)
                # fail CLOSED on NaN: a non-finite bound is collected
                bad = block[~(vals <= 0.0)]
                pre_alpha += len(bad)
                if len(bad) and alpha_iters > 0:
                    # exact filter: the alpha bound is pointwise <= plain
                    avals, _ = _evaluate(step_fn, bad,
                                         torch.full_like(bad, cert.eps), img,
                                         chunk * superchunk)
                    bad = bad[~(avals <= 0.0)]
                if len(bad):
                    viol.append(bad)
                    n_viol += len(bad)
                if n_viol > collect_cap:
                    gave = "collect_cap"
                    break
            if gave:
                stats.append(RefineStats(int(i), -1, 0, 0, False, gave,
                                         time.time() - t0, pre_alpha))
            elif not n_viol:
                # every cell passes under this pass's evaluation
                certified[i] = True
                stats.append(RefineStats(int(i), 0, 0, 0, True, "",
                                         time.time() - t0, pre_alpha))
            else:
                ok, rounds, boxes, gave = _bab(
                    step_fn, img, torch.cat(viol), cert.eps,
                    block=chunk * superchunk,
                    max_rounds=max_rounds, frontier_cap=frontier_cap,
                    box_budget=box_budget, device_cap=device_cap,
                    deadline=None if image_seconds is None
                    else t0 + image_seconds)
                if ok:
                    certified[i] = True
                stats.append(RefineStats(int(i), n_viol, rounds, boxes, ok,
                                         gave, time.time() - t0, pre_alpha))
            if on_image:
                on_image(stats[-1])
            if progress_every and (k + 1) % progress_every == 0:
                s = stats[-1]
                done = sum(1 for st in stats if st.certified)
                print(f"[refine] {k + 1}/{len(todo)} images, recovered {done} "
                      f"(last: img {i} viol={s.base_violated}"
                      f"{f'/pre-alpha {pre_alpha}' if alpha_iters else ''} "
                      f"rounds={s.rounds} boxes={s.boxes_evaluated} "
                      f"ok={s.certified}{' ' + s.gave_up if s.gave_up else ''})",
                      flush=True)
    return certified, stats


def hybrid_base_sweep(cert, images, labels, *, lips_box: bool = True,
                      chunk: int = 8192, superchunk: int = 16,
                      skip: Optional[np.ndarray] = None, on_image=None):
    """One full-grid sweep per image under the hybrid cell bound
    min(CROWN, exact centre + local Lipschitz): the strongest single-pass
    certificate.  Each bound is sound over the cell box, so the minimum is,
    and the sweep certifies every image the plain CROWN or the slack
    Lipschitz sweep certifies.

    NaN fails closed: a non-finite cell bound counts as violated and poisons
    ``worst`` to +inf.  ``certified`` requires a clean prediction too.
    ``skip`` masks images out; ``on_image`` gets each ``SweepStats``.
    Returns the SweepStats of the swept images (indices into ``images``).
    """
    labels = np.asarray(labels)
    with torch.no_grad(), float32_matmuls():
        x, y = cert._to_device(images, labels)
        clean = (cert._predict(x) == y).cpu().numpy()
        todo = np.arange(len(labels))
        if skip is not None:
            todo = todo[~np.asarray(skip, bool)[:len(labels)]]
        if not len(todo):
            return []
        sweep_fn, _ = _placed(cert, _kernels, lips_box=lips_box)
        image = _images(cert, x, todo)
        stats = []
        for k, i in enumerate(todo):
            t0 = time.time()
            img = image(k, labels[i])
            worst = torch.tensor(-math.inf, device=x.device)
            n_viol = torch.zeros((), dtype=torch.long, device=x.device)
            for block in _label_blocks(cert, img.label, chunk, superchunk):
                vals = sweep_fn(block, img)
                n_viol += (~(vals <= 0.0)).sum()  # NaN fails closed
                worst = torch.maximum(worst, torch.nan_to_num(
                    vals, nan=math.inf, posinf=math.inf,
                    neginf=-math.inf).amax())
            n_viol = int(n_viol)
            stats.append(SweepStats(
                int(i), float(worst), n_viol, bool(clean[i]),
                bool(clean[i]) and n_viol == 0, time.time() - t0))
            if on_image:
                on_image(stats[-1])
    return stats
