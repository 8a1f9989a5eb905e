"""Certification sweeps: CROWN and Lipschitz certificates over the
decision-boundary grid (counterpart of ``fiode_tpu/verify/certify.py``, on
one device).

All clean-correct images are swept together.  One block is all images x K
chunks of cells: the image axis is a leading batch axis of the same
products, each image's column swap (``grid_for_label``) is a gather inside
the block, padded cells carry ``valid = False`` and read ``-inf``.  The
running per-image worst value stays on the device and is read once per
block, where the early exit is decided.

Certificate per image (clean-correct required first):
  CROWN:     max_cells [ Vdot_ub + kappa ] <= 0,
             kappa = sqrt(2) Lfx eps_input, Lfx = 1 / min(std)
  Lipschitz: max_cells [ Vdot(grid point) + sqrt(2) Lf_eta dist + kappa ] < 0,
             Lf_eta = sqrt(n) sigma_1 alpha_1 exp(sigma_1 eta_ub) + 1,
             dist = sqrt(n) / T; the "larger-T" certificate drops the
             grid-gap slack.

The Lipschitz and witness sweeps evaluate the projected dynamics at every
grid point, (images x cells) rows at a time, through ``exact_field``: for
ReLU dynamics ``ops.fused_rhs.fused_rhs``, which launches kernel K1 on a
CUDA device and runs ``rhs_reference`` on the CPU, as the solve does; for
GroupSort dynamics the dynamics' own ``eval_dot``.  CROWN's products are ``torch.matmul`` / ``einsum`` and
the interval QP is plain elementwise PyTorch.

Certificates are float32: every sweep runs with TF32 switched off, whatever
the process-wide setting, and restores the setting afterwards.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time
from typing import Optional

import numpy as np
import torch

from ..models.dynamics import densify_dynamics_params
from ..ops.fused_rhs import fused_rhs, pack_rhs_params
from .crown import crown_mlp_bounds, optimize_crown_alphas
from .grid import enumerate_decision_boundary
from .ibp_qp import ibp_cbf_qp, ibp_sigmoid, worst_case_vdot

__all__ = ["Certifier", "CertifyResult", "summarize_stream",
           "float32_matmuls", "MATMUL_PRECISION"]

# the one precision certificates are computed at, as the records name it
MATMUL_PRECISION = "float32"
SUPERCHUNK = 16  # chunks per block: one host read of the running worst each


@contextlib.contextmanager
def float32_matmuls():
    """Run the body with TF32 off for matmuls and convolutions; restore the
    process-wide switches afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def summarize_stream(jsonl_path, out_path=None):
    """Fold a ``certify_stream`` batch log (possibly written across several
    resumed runs / segments, by this package or the JAX one) into one total
    summary dict.

    Each JSON line carries segment-cumulative ``clean`` / ``certified`` /
    ``n`` / ``cells_checked`` / ``seconds`` counters plus the absolute
    ``batch_certified_idx`` of that batch; a new segment starts whenever the
    cumulative ``n`` does not continue from the previous record (within a
    segment every record grows ``n`` by exactly its own batch size, so a
    resumed run, whose counters restart at its first batch size, is detected
    even when its batch is larger than the prior segment's total).  Totals
    are the sum of each segment's final counters; certified indices are the
    de-duplicated union across all batches.
    """
    records = []
    with open(jsonl_path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    if not records:
        raise ValueError(f"no records in {jsonl_path}")

    segments = []  # the final record of each segment
    certified_idx = set()
    larger_T_idx = set()
    n_with_larger_T = 0
    covered = set()
    last = None
    for rec in records:
        batch_n = rec["idx_to"] - rec["idx_from"] + 1
        if last is not None and rec["n"] != last["n"] + batch_n:
            segments.append(last)
        certified_idx.update(rec["batch_certified_idx"])
        if "batch_larger_T_idx" in rec:
            n_with_larger_T += 1
            larger_T_idx.update(rec["batch_larger_T_idx"])
        covered.update(range(rec["idx_from"], rec["idx_to"] + 1))
        last = rec
    segments.append(last)
    has_larger_T = n_with_larger_T == len(records)
    if 0 < n_with_larger_T < len(records):
        # a lipschitz log whose older segments predate the larger-T audit
        # field: folding would silently understate the exact-grid rate
        raise ValueError(
            f"{jsonl_path}: {n_with_larger_T}/{len(records)} records carry "
            "batch_larger_T_idx: mixed-generation log; re-run the old "
            "segments (or strip the field) before summarizing"
        )

    n_images = len(covered)
    if sum(s["n"] for s in segments) != n_images:
        raise ValueError(
            f"{jsonl_path}: segments overlap in image indices; "
            "clean counts would double-count: trim the log first"
        )
    clean = sum(s["clean"] for s in segments)
    cells = sum(s["cells_checked"] for s in segments)
    secs = sum(s["seconds"] for s in segments)
    precs = sorted({s.get("matmul_precision", "?") for s in segments})
    summary = {
        "n_images": n_images,
        "index_min": min(covered),
        "index_max": max(covered),
        "segments": len(segments),
        # scalar when all segments agree (the per-run summary shape); a
        # sorted list only for genuinely mixed-precision logs
        "matmul_precision": precs[0] if len(precs) == 1 else precs,
        "clean": clean,
        "certified": len(certified_idx),
        "clean_acc": clean / n_images,
        "certified_acc": len(certified_idx) / n_images,
        "certified_idx": sorted(certified_idx),
        "cells_checked": cells,
        "seconds": secs,
        "cells_per_sec": cells / max(secs, 1e-9),
    }
    if has_larger_T:
        summary["larger_T_certified"] = len(larger_T_idx)
        summary["larger_T_certified_acc"] = len(larger_T_idx) / n_images
        summary["larger_T_certified_idx"] = sorted(larger_T_idx)
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(summary, fh, indent=2)
    return summary


@dataclasses.dataclass
class CertifyResult:
    clean: np.ndarray  # (n_images,) bool
    certified: np.ndarray  # (n_images,) bool
    cells_per_image: int
    cells_checked: int
    seconds: float
    # filled by method='lipschitz' (grid-gap slack dropped); all False for crown
    larger_T_certified: Optional[np.ndarray] = None
    # (n_images,) float32: each clean image's worst value over the cells
    # swept (Vdot bound + kappa for crown; with the grid-gap slack for
    # lipschitz), NaN where the image is not clean.  After an early exit it
    # is the worst so far, a lower bound of the full sweep's.
    worst: Optional[np.ndarray] = None
    # the same without the grid-gap slack (lipschitz only)
    worst_larger_T: Optional[np.ndarray] = None

    @property
    def clean_acc(self):
        return float(self.clean.mean())

    @property
    def certified_acc(self):
        return float(self.certified.mean())

    @property
    def cells_per_sec(self):
        return self.cells_checked / max(self.seconds, 1e-9)


def label_perms(labels: torch.Tensor, n: int) -> torch.Tensor:
    """(I, n) column permutations: eta[:, perm] swaps columns 0 <-> label."""
    I = labels.shape[0]
    perms = torch.arange(n, device=labels.device).repeat(I, 1)
    rows = torch.arange(I, device=labels.device)
    perms[rows, 0] = labels
    perms[rows, labels] = 0
    return perms


class Certifier:
    """Sweeps the decision-boundary grid for a ``NeuralODEClassifier`` on the
    device the model lies on.

    ``alpha_iters`` > 0 tightens the ReLU lower slopes per chunk
    (alpha-CROWN; 0 is plain CROWN).  ``alpha_objective`` picks what the
    slopes are optimised against: "vdot", the certified quantity itself
    (through the interval QP), or "width", the total MLP bound width
    sum(ub - lb) per cell, a smooth surrogate with a cheaper gradient; with
    "width" the best iterate per cell is still selected by the certified
    quantity, so the result is never worse than plain CROWN.  Soundness is
    unaffected either way.
    """

    matmul_precision = MATMUL_PRECISION

    def __init__(self, model, *, T: int = 40, eps_input: float = 36 / 255,
                 chunk: int = 8192, scale_nominal: bool = False,
                 with_upper: bool = False, grid: Optional[np.ndarray] = None,
                 std_min: Optional[float] = None, alpha_iters: int = 0,
                 alpha_objective: str = "vdot"):
        self.model = model
        self.device = next(model.parameters()).device
        self.T = T
        self.eps = 1.0 / T  # per-cell Linf radius
        self.chunk = chunk
        self.scale_nominal = scale_nominal
        self.with_upper = with_upper
        self.alpha_iters = int(alpha_iters)
        if alpha_objective not in ("vdot", "width"):
            raise ValueError(alpha_objective)
        self.alpha_objective = alpha_objective
        dyn = model.dynamics
        self.n = dyn.n_hidden
        self.alpha_1, self.alpha_2, self.sigma_1 = (dyn.alpha_1, dyn.alpha_2,
                                                    dyn.sigma_1)
        if std_min is None:
            norm = getattr(model.backbone, "norm", None)
            std_min = min(norm.std_values) if norm is not None else 1.0
        # Lipschitz constant of the dynamics wrt x through the Lip-1 backbone
        # and Normalize.  CROWN uses 1 / min(std) unconditionally; the
        # Lipschitz certificate must widen by alpha_1 when scale_nominal is
        # on: the sigmoid rescaling multiplies the input sensitivity.
        self.Lfx = 1.0 / std_min
        self.kappa = float(np.sqrt(2.0) * self.Lfx * eps_input)
        lfx_lips = (dyn.alpha_1 if scale_nominal else 1.0) / std_min
        self.kappa_lips = float(np.sqrt(2.0) * lfx_lips * eps_input)

        with torch.no_grad():
            dense = densify_dynamics_params(dyn)
            (W1, b1), (W2, b2), (W3, b3) = (
                tuple(t.detach().to(torch.float32).contiguous() for t in dense[k])
                for k in ("hidden_to_mlp", "mlp_to_mlp", "mlp_to_hidden"))
            self.Ws, self.bs = [W1, W2, W3], [b1, b2, b3]
            self.U, self.bU = (t.detach().to(torch.float32)
                               for t in dense["U_x"])

        if grid is None:
            grid = enumerate_decision_boundary(self.n, T)
        self.grid = np.asarray(grid, np.float32)
        if len(self.grid) == 0:
            raise ValueError("Certifier needs a non-empty decision-boundary grid")
        self._grid_dev: Optional[torch.Tensor] = None

    # -- clean check ---------------------------------------------------------

    def _to_device(self, images, labels):
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        y = torch.as_tensor(labels).to(self.device, torch.long)
        return x, y

    def _predict(self, x: torch.Tensor) -> torch.Tensor:
        """Predicted classes.  The clean check integrates the field the
        certificate bounds: this certifier's ``scale_nominal``, not the
        dynamics module's constructor flag."""
        model = self.model
        sol = model.solve(x, scale_nominal=self.scale_nominal)
        if sol.attempts >= model.max_steps:
            raise RuntimeError(
                f"solver hit the max_steps={model.max_steps} step budget "
                f"(attempts={sol.attempts}) in the clean check: raise "
                "max_steps; certifying on a truncated solve would be unsound"
            )
        return model.output_fn(sol.ys[-1]).argmax(-1)

    # -- blocks ---------------------------------------------------------------

    def iter_blocks(self, superchunk: int = SUPERCHUNK,
                    chunk: Optional[int] = None):
        """Yield (K, C, n) base-grid cell blocks and (K, C) validity masks on
        the device, every block of one shape (the last padded with invalid
        cells), C = ``chunk`` (default: this certifier's).
        Label-independent: the per-label column swap happens inside the
        block through per-image permutations."""
        if self._grid_dev is None:
            self._grid_dev = torch.from_numpy(self.grid).to(self.device)
        g, C = self._grid_dev, chunk or self.chunk
        block_cells = C * superchunk
        for i in range(0, len(g), block_cells):
            block = g[i:i + block_cells]
            n_valid = len(block)
            if n_valid < block_cells:
                block = torch.cat([block, block.new_zeros(
                    (block_cells - n_valid, self.n))])
            valid = torch.arange(block_cells, device=g.device) < n_valid
            yield (block.view(superchunk, C, self.n),
                   valid.view(superchunk, C), n_valid)

    @staticmethod
    def swap_columns(eta: torch.Tensor, perms: torch.Tensor) -> torch.Tensor:
        """(C, n) cells -> (I, C, n): row i holds eta[:, perms[i]]."""
        I, (C, n) = perms.shape[0], eta.shape
        return eta.expand(I, C, n).gather(2, perms[:, None, :].expand(I, C, n))

    def crown_block(self, x_biases, labels, perms, etas, valids, worst):
        """One CROWN block: x_biases (I, m1), labels (I,), perms (I, n),
        etas (K, C, n), valids (K, C), worst (I,) the running per-image
        worst Vdot + kappa.  Returns the updated worst."""
        eps, Ws, bs = self.eps, self.Ws, self.bs
        a1, a2, s1 = self.alpha_1, self.alpha_2, self.sigma_1
        I, (K, C, n) = perms.shape[0], etas.shape
        x_rows = x_biases[:, None, :].expand(I, C, -1).reshape(I * C, -1)
        label_rows = labels[:, None].expand(I, C).reshape(I * C)
        for k in range(K):
            eta_l = self.swap_columns(etas[k], perms).reshape(I * C, n)

            def post(lb, ub):
                # the rest of the certificate chain after the MLP bounds
                if self.scale_nominal:
                    lb, ub = ibp_sigmoid(lb, ub, eta_l - eps, eta_l + eps,
                                         a1, s1, a2)
                f_lb, f_ub = ibp_cbf_qp(eta_l, eps, lb, ub, a1, s1, a2,
                                        with_upper=self.with_upper)
                return worst_case_vdot(eta_l, eps, f_lb, f_ub, label_rows)

            alphas = None
            if self.alpha_iters:
                if self.alpha_objective == "width":
                    # the gradient comes from the smooth width surrogate,
                    # but the per-cell best iterate is selected by the
                    # certified quantity, so this cannot lose a certificate
                    # that plain CROWN (iterate 0) had
                    loss_fn = lambda lb, ub: (ub - lb).sum(-1)  # noqa: E731
                    select_fn = post
                else:
                    loss_fn, select_fn = post, None
                alphas = optimize_crown_alphas(
                    Ws, bs, eta_l, eps, x_rows, loss_fn=loss_fn,
                    iters=self.alpha_iters, select_fn=select_fn)
            lb, ub = crown_mlp_bounds(Ws, bs, eta_l, eps, x_rows, alphas)
            vdot = post(lb, ub).view(I, C)
            vdot = torch.where(valids[k], vdot, float("-inf"))
            worst = torch.maximum(worst, vdot.amax(1) + self.kappa)
        return worst

    def _exact_vdot(self, p, xc_rows, perms, onehot, eta):
        """Exact Vdot at the lattice points of one chunk for every image:
        (I, C) values and the (I, C, n) label-space cells."""
        I, (C, n) = perms.shape[0], eta.shape
        eta_l = self.swap_columns(eta, perms)
        f = self.exact_field(p, xc_rows, eta_l.reshape(I * C, n)).view(I, C, n)
        neg_inf = float("-inf")
        wrong = torch.where(onehot, neg_inf, eta_l)
        max_wrong = wrong.amax(-1, keepdim=True)
        # exact comparison: both sides are lattice values k / T
        runner = (eta_l == max_wrong) & ~onehot
        f_y = torch.where(onehot, f, 0.0).sum(-1)
        f_w = torch.where(runner, f, neg_inf).amax(-1)
        return -f_y + f_w, eta_l

    def rhs_rows(self, feats, C):
        """The exact field's inputs for I images x C cells each: for ReLU
        dynamics the packed K1 weights and the injection xc = x U^T + bU + b1
        repeated per cell; for GroupSort dynamics no weights (None) and the
        features repeated per cell."""
        if self.model.dynamics.activation == "ReLU":
            W1, W2, W3 = self.Ws
            b1, b2, b3 = self.bs
            p = pack_rhs_params(W1, W2, W3, b2, b3)
            rows = feats @ self.U.T + self.bU + b1  # (I, mlp)
        else:
            p, rows = None, feats
        I = rows.shape[0]
        return p, rows[:, None, :].expand(I, C, -1).reshape(I * C, -1).contiguous()

    def exact_field(self, p, in_rows, h):
        """The projected dynamics at the states h (R, n), with ``p`` and the
        (R, ...) inputs of ``rhs_rows``: K1 for ReLU dynamics, the dynamics'
        ``eval_dot`` for GroupSort, at this certifier's scale_nominal."""
        dyn = self.model.dynamics
        if p is None:
            return dyn.eval_dot(h, in_rows, scale_nominal=self.scale_nominal)
        return fused_rhs(h, in_rows, p, self.alpha_1, self.sigma_1,
                         self.alpha_2, self.scale_nominal, dyn.qp_iters)

    def lips_block(self, p, xc_rows, labels, perms, etas, valids, worst):
        """One Lipschitz block; ``worst`` is the pair (with the grid-gap
        slack, without it) of (I,) running per-image worst values."""
        n, eps = self.n, self.eps
        a1, s1 = self.alpha_1, self.sigma_1
        dist = math.sqrt(n) / self.T  # grid gap
        onehot = (labels[:, None] == torch.arange(n, device=labels.device))[:, None, :]
        neg_inf = float("-inf")
        wf, wl = worst
        for k in range(etas.shape[0]):
            vdot, eta_l = self._exact_vdot(p, xc_rows, perms, onehot, etas[k])
            eta_ub = eta_l.amax(-1) + eps
            Lf_eta = math.sqrt(n) * (s1 * a1 * torch.exp(s1 * eta_ub)) + 1.0
            slack = math.sqrt(2.0) * Lf_eta * dist
            v_full = torch.where(valids[k], vdot + slack + self.kappa_lips, neg_inf)
            v_larger_T = torch.where(valids[k], vdot + self.kappa_lips, neg_inf)
            wf = torch.maximum(wf, v_full.amax(1))
            wl = torch.maximum(wl, v_larger_T.amax(1))
        return wf, wl

    def witness_block(self, p, xc_rows, labels, perms, etas, valids, carry,
                      base_idx: int):
        """One block of the exact sweep with its argmax: ``carry`` is
        (values (I,), cell indices (I,))."""
        n = self.n
        onehot = (labels[:, None] == torch.arange(n, device=labels.device))[:, None, :]
        wv, wi = carry
        C = etas.shape[1]
        for k in range(etas.shape[0]):
            vdot, _ = self._exact_vdot(p, xc_rows, perms, onehot, etas[k])
            v = torch.where(valids[k], vdot + self.kappa_lips, float("-inf"))
            vmax, j = v.max(dim=1)
            idx = base_idx + k * C + j
            better = vmax > wv
            wv = torch.where(better, vmax, wv)
            wi = torch.where(better, idx, wi)
        return wv, wi

    # -- sweeps ---------------------------------------------------------------

    @torch.no_grad()
    def exact_witness(self, images, labels):
        """Per-image argmax witness of the exact grid sweep.

        For each image, evaluates the exact Vdot + kappa_lips at every grid
        lattice point (the larger-T certificate's quantity) and returns the
        maximising cell.  A strictly positive witness refutes certifiability
        of that image at this (T, eps, kappa) protocol for any sound box
        method: the lattice point is the centre of its cell's box, so every
        sound upper bound over any box containing it is >= the exact value.
        A negative witness is the image's exact margin.

        Returns ``(values (N,), cell_idx (N,) int64 into self.grid,
        clean (N,) bool)`` as numpy arrays.  ``cell_idx`` rows index the raw
        grid (coordinate 0 tied); apply the image's label swap for
        label-space coordinates.
        """
        with float32_matmuls():
            x, y = self._to_device(images, labels)
            clean = (self._predict(x) == y).cpu().numpy()
            feats = self.model.features(x)
            n_imgs = len(x)
            perms = label_perms(y, self.n)
            p, xc_rows = self.rhs_rows(feats, self.chunk)
            carry = (torch.full((n_imgs,), float("-inf"), device=self.device),
                     torch.zeros(n_imgs, dtype=torch.long, device=self.device))
            base = 0
            for etas, valids, _ in self.iter_blocks():
                carry = self.witness_block(p, xc_rows, y, perms, etas, valids,
                                           carry, base)
                base += etas.shape[0] * etas.shape[1]
            return carry[0].cpu().numpy(), carry[1].cpu().numpy(), clean

    @torch.no_grad()
    def certify(self, images, labels, method: str = "crown",
                early_exit: bool = True,
                progress_every: int = 0) -> CertifyResult:
        """Certify a batch of images (arrays or tensors; moved to the
        certifier's device).

        ``early_exit`` stops the sweep once every image is already violated;
        for ``method="lipschitz"`` only once the larger-T certificate, whose
        worst value is the smaller one, is violated for every image, so that
        a truncated sweep never emits an unsound larger-T verdict.
        """
        if method not in ("crown", "lipschitz"):
            raise ValueError(method)
        with float32_matmuls():
            return self._certify(images, labels, method, early_exit,
                                 progress_every)

    def _certify(self, images, labels, method, early_exit, progress_every):
        x, y = self._to_device(images, labels)
        n_imgs = len(x)
        certified = np.zeros(n_imgs, bool)
        larger_T_certified = np.zeros(n_imgs, bool)
        worst_out = np.full(n_imgs, np.nan, np.float32)
        worst_larger_T = np.full(n_imgs, np.nan, np.float32)
        cells_checked = 0

        # batched clean check and feature extraction up front
        clean_t = self._predict(x) == y
        all_feats = self.model.features(x)
        clean = clean_t.cpu().numpy()
        t0 = time.time()

        clean_idx = np.nonzero(clean)[0]
        I = len(clean_idx)
        if I:
            sel = torch.from_numpy(clean_idx).to(self.device)
            labs = y[sel]
            perms = label_perms(labs, self.n)
            feats = all_feats[sel]
            start = torch.full((I,), float("-inf"), device=self.device)
            n_blocks = 0
            if method == "crown":
                x_biases = feats @ self.U.T + self.bU
                worst = start

                def step(etas, valids, worst):
                    return self.crown_block(x_biases, labs, perms, etas,
                                            valids, worst)

                violated = lambda w: w > 0  # noqa: E731
                worsts = lambda w: (w, w)  # noqa: E731
            else:
                p, xc_rows = self.rhs_rows(feats, self.chunk)
                worst = (start, start.clone())

                def step(etas, valids, worst):
                    return self.lips_block(p, xc_rows, labs, perms, etas,
                                           valids, worst)

                violated = lambda w: w >= 0  # noqa: E731
                worsts = lambda w: w  # noqa: E731
            for etas, valids, n_valid in self.iter_blocks():
                worst = step(etas, valids, worst)
                cells_checked += n_valid * I
                n_blocks += 1
                # one host read per block
                w_full, w_exit = (w.cpu().numpy() for w in worsts(worst))
                if progress_every and n_blocks % progress_every == 0:
                    el = time.time() - t0
                    print(f"[certify:{method}] block {n_blocks} "
                          f"viol={violated(w_full).mean():.3f} "
                          f"({cells_checked / max(el, 1e-9):,.0f} cells/s)",
                          flush=True)
                if early_exit and violated(w_exit).all():
                    break
            certified[clean_idx] = ~violated(w_full)
            worst_out[clean_idx] = w_full
            if method == "lipschitz":
                larger_T_certified[clean_idx] = ~violated(w_exit)
                worst_larger_T[clean_idx] = w_exit

        return CertifyResult(
            clean=clean, certified=certified, cells_per_image=len(self.grid),
            cells_checked=cells_checked, seconds=time.time() - t0,
            larger_T_certified=larger_T_certified, worst=worst_out,
            worst_larger_T=worst_larger_T if method == "lipschitz" else None,
        )

    def certify_stream(self, images, labels, method: str = "crown",
                       image_batch: int = 10, out_path: Optional[str] = None,
                       start_ind: int = 0) -> CertifyResult:
        """Streamed sweep: certify images in batches, printing cumulative
        clean / certified accuracy after every batch and appending one JSON
        line per batch to ``out_path`` (a resume-friendly audit log, the
        lines and the final summary at ``out_path`` + ".json" field for
        field those of the JAX package, so ``summarize_stream`` of either
        package folds a log written by either).

        ``start_ind`` only offsets the printed and recorded test indices."""
        n = len(images)
        clean = np.zeros(n, bool)
        certified = np.zeros(n, bool)
        larger_T = np.zeros(n, bool)
        worst = np.full(n, np.nan, np.float32)
        worst_larger_T = np.full(n, np.nan, np.float32)
        cells_checked = 0
        t0 = time.time()
        log_fh = open(out_path, "a") if out_path else None
        try:
            for i in range(0, n, image_batch):
                sl = slice(i, min(i + image_batch, n))
                r = self.certify(images[sl], labels[sl], method=method,
                                 early_exit=True)
                clean[sl] = r.clean
                certified[sl] = r.certified
                larger_T[sl] = r.larger_T_certified
                worst[sl] = r.worst
                if r.worst_larger_T is not None:
                    worst_larger_T[sl] = r.worst_larger_T
                cells_checked += r.cells_checked
                done = sl.stop
                el = time.time() - t0
                print(f"[certify:{method}] idx {start_ind}..."
                      f"{start_ind + done - 1}: "
                      f"clean {clean[:done].sum()}/{done} "
                      f"certified {certified[:done].sum()}/{done} "
                      f"({cells_checked / max(el, 1e-9):,.0f} cells/s, "
                      f"{el:,.0f}s)", flush=True)
                if log_fh:
                    line = {
                        "idx_from": start_ind + sl.start,
                        "idx_to": start_ind + done - 1,
                        "clean": int(clean[:done].sum()),
                        "certified": int(certified[:done].sum()),
                        "n": done,
                        "batch_certified_idx": (
                            start_ind + sl.start + np.nonzero(r.certified)[0]
                        ).tolist(),
                        "cells_checked": cells_checked,
                        "seconds": el,
                        "matmul_precision": self.matmul_precision,
                    }
                    if method == "lipschitz":
                        # the larger-T verdicts are part of the lipschitz
                        # result: without them in the audit log a killed
                        # sweep's completed batches would lose their
                        # exact-grid certificates on resume
                        line["batch_larger_T_idx"] = (
                            start_ind + sl.start
                            + np.nonzero(r.larger_T_certified)[0]
                        ).tolist()
                    log_fh.write(json.dumps(line) + "\n")
                    log_fh.flush()
        finally:
            if log_fh:
                log_fh.close()
        res = CertifyResult(
            clean=clean, certified=certified, cells_per_image=len(self.grid),
            cells_checked=cells_checked, seconds=time.time() - t0,
            larger_T_certified=larger_T, worst=worst,
            worst_larger_T=worst_larger_T if method == "lipschitz" else None,
        )
        if out_path:
            summary = {
                "n_images": n,
                "start_ind": start_ind,
                "method": method,
                "matmul_precision": self.matmul_precision,
                "T": self.T,
                "kappa": self.kappa if method == "crown" else self.kappa_lips,
                "clean_acc": res.clean_acc,
                "certified_acc": res.certified_acc,
                "certified_idx": (start_ind + np.nonzero(certified)[0]).tolist(),
                "clean_idx": (start_ind + np.nonzero(clean)[0]).tolist(),
                "cells_checked": cells_checked,
                "cells_per_sec": res.cells_per_sec,
                "seconds": res.seconds,
            }
            if method == "lipschitz":
                summary["larger_T_certified_acc"] = float(larger_T.mean())
                summary["larger_T_certified_idx"] = (
                    start_ind + np.nonzero(larger_T)[0]).tolist()
            with open(str(out_path) + ".json", "w") as fh:
                json.dump(summary, fh, indent=2)
        return res
