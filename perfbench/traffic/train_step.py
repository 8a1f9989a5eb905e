"""Lyapunov training: ``LyapunovTrainer._train_step`` back to back on
batches of B images, with S sampled states an image, at the settings
``fit`` uses in a steady epoch (``epoch``: past ``epoch_off_scale``, so
the squash is off, and past the sampler schedulers' start; the cosine
learning rate at that epoch's update count).

Inputs: a pool of ``pool`` batches of images uniform in [0, 1) and labels,
drawn from the seed on the device; step i takes batch i mod pool.  Every
step's crop offsets, flips and sampler draws are drawn from the seed by
the benchmark and handed in through ``draws``; the dropout masks come from
the trainer's own generator, seeded from the seed.

Set-up builds the trainer and drives it through its first
``checked_steps`` steps, on batches that all differ, through the window's
own call; the window continues with that same trainer.  Output check: the
plain reference (``perfbench/reference/train.py``) follows those steps
from the same raw weights, inputs, draws and dropout masks, in float32
with TF32 off.  Compared, each as a gap of norms over the reference's norm
of that leaf or of the median leaf, whichever is larger, taken by the
worst leaf: the first gradient as Adam holds it after one step
(``grad_gap``) and the parameters' change over the checked steps
(``change_gap``; leaves whose reference gradient is under a thousandth of
the median leaf's are left out: they move by round-off alone); and the
first step's loss (``loss_gap``, over the reference's loss).  The later
steps' losses go to stderr and are not compared: Adam's first update moves
every parameter by about lr whatever its gradient's size, so round-off on
a gradient near zero moves a parameter by up to 2 lr on one side only, and
the next steps' losses carry that (PERF.md gives the readings).
"""
from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from perfbench import harness, weights
from perfbench.reference import train as ref_train

__all__ = ["setup", "window", "traced_slice", "release", "check", "answers"]

AUG_PAD = 4


class State:
    pass


def _scheduler(cfg):
    from fiode_tpu_torch.train.schedulers import (CompositeSamplerScheduler,
                                                  LinearScheduler)
    return CompositeSamplerScheduler(
        [LinearScheduler(**s) for s in cfg["sampler_schedulers"]],
        cfg["scheduler_weights"])


def setup(cell: dict, seed: int, device) -> State:
    from fiode_tpu_torch.train.data import Dataset
    from fiode_tpu_torch.train.trainer import LyapunovTrainer, TrainConfig
    cfg, mix = cell["config"], cell["mix"]
    st = State()
    st.cfg, st.mix, st.device, st.seed = cfg, mix, torch.device(device), seed
    B, S = cfg["batch_size"], cfg["h_sample_size"]
    c, n = cfg["in_channels"], cfg["img_size"]
    model = harness.program_model(cfg, device)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    st.params = weights.draw(shapes, harness.subseed(seed, 0), device)
    weights.load(model, st.params)
    g = torch.Generator(device).manual_seed(harness.subseed(seed, 1))
    st.x = torch.rand((mix["pool"], B, c, n, n), generator=g, device=device)
    st.y = torch.randint(0, cfg["n_hidden"], (mix["pool"], B), generator=g,
                         device=device)
    blank = np.zeros((B, c, n, n), np.float32)
    labels = np.zeros(B, np.int32)
    ds = Dataset("CIFAR10", blank, labels, blank, labels, blank, labels,
                 cfg["n_hidden"], synthetic=True)
    tcfg = TrainConfig(
        opt_name=cfg["opt_name"], lr=cfg["lr"], beta1=cfg["beta1"],
        beta2=cfg["beta2"], weight_decay=cfg["weight_decay"],
        scheduler_name=cfg["scheduler_name"], max_epochs=cfg["max_epochs"],
        batch_size=B, augment=True, h_sample_size=S,
        h_dist_lim=cfg["h_dist_lim"], act=cfg["act"], lya_cand=cfg["lya_cand"],
        sampler_names=tuple(cfg["samplers"]),
        epoch_off_scale=cfg["epoch_off_scale"], eps=cfg["eps"],
        seed=harness.subseed(seed, 3) % (2 ** 31))
    st.run_dir = tempfile.mkdtemp(prefix="perfbench-train-")
    st.trainer = LyapunovTrainer(model, tcfg, ds, scheduler=_scheduler(cfg),
                                 run_dir=st.run_dir, device=device)
    st.trainer.reset_optimizer(False)
    st.trainer.steps_per_epoch = cfg["steps_per_epoch"]
    epoch = mix["epoch"]
    st.count0 = epoch * cfg["steps_per_epoch"]
    st.trainer.opt_count = st.count0
    st.mixer = np.asarray(_scheduler(cfg).get_mixer_coefficients(epoch),
                          np.float32)
    st.scale_nominal = bool(cfg["scale_nominal"] and epoch < cfg["epoch_off_scale"])
    st.masks_seed = harness.subseed(seed, 4)
    st.trainer.gen.manual_seed(st.masks_seed)
    st.g_draw = torch.Generator(device).manual_seed(harness.subseed(seed, 2))
    st.p0 = _params(st)
    st.checked_draws, st.checked_losses = [], []
    for i in range(mix["checked_steps"]):  # also the warm-up
        d = _draws(st)
        st.checked_draws.append(d)
        st.checked_losses.append(_step(st, i, d))
        if i == 0:
            st.g1 = _first_gradient(st)
    st.pk = _params(st)
    st.next = mix["checked_steps"]
    _sync(st)
    return st


def _params(st):
    return {k: p.detach().clone()
            for k, p in st.trainer.model.named_parameters()}


def _first_gradient(st):
    """The first gradient as Adam holds it after one step: m / (1 - b1);
    zero for a parameter it holds nothing for."""
    opt, b1 = st.trainer.opt, st.cfg["beta1"]
    out = {}
    for k, p in st.trainer.model.named_parameters():
        m = opt.state.get(p, {}).get("exp_avg")
        out[k] = torch.zeros_like(p) if m is None else m.detach() / (1.0 - b1)
    return out


def _draws(st):
    B, S, n = st.cfg["batch_size"], st.cfg["h_sample_size"], st.cfg["n_hidden"]
    g, d = st.g_draw, st.device
    off = torch.randint(0, 2 * AUG_PAD + 1, (B, 2), generator=g, device=d)
    flip = torch.rand((B,), generator=g, device=d) < 0.5
    samples = [(torch.empty((B, S, n), device=d).exponential_(generator=g),)
               for _ in st.cfg["samplers"]]
    return {"augment": (off, flip), "samples": samples}


def _step(st, i, draws):
    P = st.x.shape[0]
    loss, _ = st.trainer._train_step(st.x[i % P], st.y[i % P], st.count0 + i,
                                     st.mixer, 0.0, st.scale_nominal,
                                     draws=draws)
    return loss


def _sync(st):
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)


def window(st: State, seconds: float) -> None:
    """Steps back to back until ``seconds`` have passed; the window ends
    when the device has finished the last one."""
    losses = []
    _sync(st)
    t_start = time.perf_counter()
    stop, i = t_start + seconds, st.next
    while time.perf_counter() < stop:
        losses.append(_step(st, i, _draws(st)))
        i += 1
    _sync(st)
    t1 = time.perf_counter()
    steps = i - st.next
    st.next = i
    st.window = {"seconds": t1 - t_start, "attempted": steps,
                 "losses": losses, "items": steps * st.cfg["batch_size"]}


def traced_slice(st: State) -> int:
    k = st.mix["profile_steps"]
    for j in range(k):
        _step(st, st.next + j, _draws(st))
    _sync(st)
    return k


def failures(st: State) -> int:
    losses = torch.stack(st.window["losses"] + st.checked_losses)
    return int((~torch.isfinite(losses)).sum())


def release(st: State) -> None:
    st.answers = {"losses": [float(v) for v in st.checked_losses],
                  "g1": st.g1, "pk": st.pk}
    st.trainer.writer.close()
    shutil.rmtree(st.run_dir, ignore_errors=True)
    st.trainer = st.window["losses"] = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def _half(h, f, y, kappa):
    """A fault: the loss's mean over the first half of the rows only."""
    k = h.shape[0] // 2
    return ref_train.lyapunov_loss(h[:k], f[:k], y[:k], kappa)


def reference(st: State, loss_fn=ref_train.lyapunov_loss) -> dict:
    """The reference's losses, first gradient and parameters after the
    checked steps."""
    cfg, mix = st.cfg, st.mix
    B, S, m = cfg["batch_size"], cfg["h_sample_size"], cfg["mlp_size"]
    g = torch.Generator(st.device).manual_seed(st.masks_seed)
    params = dict(st.p0)
    opt = ref_train.Adam(params, cfg)
    P, losses, g1 = st.x.shape[0], [], None
    kappa = float(np.float32(cfg["kappa"]))
    for i, d in enumerate(st.checked_draws):
        masks = [torch.rand((B * S, m), generator=g, device=st.device)
                 for _ in range(2)]
        loss, grads, params = ref_train.step(
            params, opt, st.count0 + i, st.x[i % P], st.y[i % P], d, masks,
            cfg, st.mixer, kappa, st.scale_nominal, loss_fn)
        losses.append(float(loss))
        if i == 0:
            g1 = grads
    return {"losses": losses, "g1": g1, "pk": params}


def answers(st: State, control: str | None = None) -> dict:
    """The program's answers, or the reference's computed the way
    ``control`` says: ``"tf32"`` (TF32 matmuls), ``"half_batch"`` (the
    loss's mean over half of the rows), ``"unchanged"`` (no update)."""
    if control is None:
        return st.answers
    if control == "tf32":
        with harness.tf32(True):
            return reference(st)
    if control == "half_batch":
        with harness.tf32(False):
            return reference(st, loss_fn=_half)
    if control == "unchanged":
        with harness.tf32(False):
            return dict(reference(st), pk=st.p0)
    raise ValueError(f"no control {control!r} for the training step")


def _leaf_gap(what: str, got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap of norms over max(its reference norm, the
    median leaf's); the three worst go to stderr."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    median = float(np.median(list(norms.values())))
    gaps = {}
    for k in want:
        if keep is not None and k not in keep:
            continue
        d = abs(float(got[k].norm()) - norms[k]) / max(norms[k], median, 1e-30)
        gaps[k] = d if np.isfinite(d) else np.inf
    for k in sorted(gaps, key=gaps.get)[-3:]:
        harness.log(f"{what} {k}: gap {gaps[k]:.3e}, reference norm "
                    f"{norms[k]:.3e}, median {median:.3e}")
    return max(gaps.values())


def check(st: State, control: str | None = None) -> dict:
    got = answers(st, control)
    with harness.tf32(False):
        want = reference(st)
    steps = [abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(got["losses"], want["losses"])]
    harness.log(f"loss gaps by step: {steps}")
    loss_gap = steps[0]
    if not np.isfinite(loss_gap):
        loss_gap = np.inf
    g_norms = {k: float(v.norm()) for k, v in want["g1"].items()}
    floor = 1e-3 * float(np.median(list(g_norms.values())))
    keep = {k for k, v in g_norms.items() if v >= floor}
    change = {k: got["pk"][k] - st.p0[k] for k in st.p0}
    change_ref = {k: want["pk"][k] - st.p0[k] for k in st.p0}
    return {"loss_gap": float(loss_gap),
            "grad_gap": _leaf_gap("grad", got["g1"], want["g1"]),
            "change_gap": _leaf_gap("change", change, change_ref, keep)}
