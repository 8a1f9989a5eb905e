"""Plain reference of one Lyapunov training step with Adam: crop and flip,
the KWLarge features, the composite sampler's states, the dynamics with
dropout, the decision-boundary candidate's V and Vdot, the mean violation,
its gradients by autograd and Adam's update at the cosine learning rate.

Frozen copies, at commit 08631d7, of ``fiode_tpu_torch/train/data.py``
(``augment_batch``), ``fiode_tpu_torch/train/samplers.py`` (the uniform
simplex and correct-cone transforms, ``slot_counts``,
``composite_sample``), ``fiode_tpu_torch/train/trainer.py`` (``_lr`` for
cos_anneal), and of ``torch.optim.Adam``'s update.  ``lyapunov_loss`` of
``fiode_tpu_torch/train/lyapunov.py`` takes V and Vdot from a forward-mode
``jvp``; here Vdot is written out, <grad V, f> with grad V the label's
-1 and, on the largest wrong coordinates, 1 shared among ties.  Imports
nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

from . import model as ref

__all__ = ["augment", "sample_states", "lyapunov_loss", "learning_rate",
           "Adam", "step"]

AUG_PAD = 4


def augment(x, off, flip):
    B, C, H, W = x.shape
    xp = torch.nn.functional.pad(x, (AUG_PAD,) * 4)
    rows = off[:, 0:1, None] + torch.arange(H, device=x.device)[None, :, None]
    cols = off[:, 1:2, None] + torch.arange(W, device=x.device)[None, None, :]
    b = torch.arange(B, device=x.device)[:, None, None]
    cropped = xp.permute(0, 2, 3, 1)[b, rows, cols].permute(0, 3, 1, 2)
    return torch.where(flip[:, None, None, None], cropped.flip(-1), cropped)


def _uniform(y, e):
    return e / e.sum(-1, keepdim=True)


def _correct_cone(y, e):
    h = e / e.sum(-1, keepdim=True)
    max_val, max_idx = torch.max(h, dim=-1, keepdim=True)
    lab = y[:, None, None].expand(-1, h.shape[1], 1)
    lab_val = torch.take_along_dim(h, lab, dim=-1)
    return h.scatter(-1, max_idx, lab_val).scatter(-1, lab, max_val)


SAMPLERS = {"UniformSimplexSampling": _uniform,
            "CorrectConeSampling": _correct_cone}


def sample_states(names, mixer, y, draws):
    """(B, S, n): sampler i fills its floor(S c_i) slots (the last takes the
    rest) from its exponential draws (B, S, n)."""
    S = draws[0][0].shape[1]
    counts = np.floor(np.float32(S) * np.asarray(mixer, np.float32)).astype(np.int64)
    counts[-1] = S - counts[:-1].sum()
    parts, start = [], 0
    for name, d, k in zip(names, draws, counts):
        parts.append(SAMPLERS[name](y, d[0])[:, start:start + k])
        start += k
    return torch.cat(parts, dim=1)


def lyapunov_loss(h, f, y, kappa: float):
    """mean relu(Vdot + kappa V) for V = 1 + max_{j != y} h_j - h_y."""
    n = h.shape[-1]
    onehot = torch.nn.functional.one_hot(y, n).bool()
    wrong = torch.where(onehot, float("-inf"), h)
    top = wrong.amax(-1, keepdim=True)
    ties = (wrong == top).to(h.dtype)
    grad_v = ties / ties.sum(-1, keepdim=True) - onehot.to(h.dtype)
    v = 1.0 + top[:, 0] - torch.where(onehot, h, 0.0).sum(-1)
    vdot = (grad_v * f).sum(-1)
    return torch.relu(vdot + kappa * v).mean()


def learning_rate(count: int, cfg: dict) -> float:
    """The cosine-annealed rate at the optimizer's update count, in float32."""
    f32 = np.float32
    epoch = count // cfg["steps_per_epoch"]
    c = np.cos(f32(np.pi) * f32(epoch) / f32(cfg["max_epochs"]))
    return float(f32(cfg["lr"] * 0.5) * (f32(1.0) + c))


class Adam:
    """Adam with bias correction, eps outside the square root."""

    def __init__(self, params: dict, cfg: dict):
        self.b1, self.b2, self.eps = cfg["beta1"], cfg["beta2"], 1e-8
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def update(self, params: dict, grads: dict, lr: float) -> dict:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / (c2 ** 0.5) + self.eps
            out[k] = p - (lr / c1) * self.m[k] / denom
        return out


def step(params: dict, opt: Adam, count: int, x, y, draws: dict, masks,
         cfg: dict, mixer, kappa: float, scale_nominal: bool = False,
         loss_fn=lyapunov_loss):
    """One training step from ``params``: returns (loss, gradients, the
    updated parameters)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    off, flip = draws["augment"]
    feats = ref.backbone(leaves, augment(x, off, flip), cfg)
    B, n = feats.shape[0], cfg["n_hidden"]
    h = sample_states(cfg["samplers"], mixer, y, draws["samples"])
    S = h.shape[1]
    h = h.reshape(B * S, n).detach()
    x_in = feats[:, None, :].expand(B, S, feats.shape[-1]).reshape(B * S, -1)
    dense = ref.dense_dynamics(leaves)
    f = ref.eval_dot_train(h, x_in, dense, cfg, masks, scale_nominal)
    loss = loss_fn(h, f, y.repeat_interleave(S), kappa)
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                allow_unused=True)
    grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
             for k, g in zip(names, grads)}
    new = opt.update({k: v.detach() for k, v in leaves.items()}, grads,
                     learning_rate(count, cfg))
    return loss.detach(), grads, new
