"""A whole run of each cell on the CPU at a tiny size, the look for a card
skipped: sound, it comes out correct; with the timed path broken
underneath, it comes out not correct, once for each fault the cell can
have (a step that returns its state unchanged; half of the batch left
out, the mean taken over the rest; an answer altered where it is
produced).  The cells run on one chip, so none has an exchange between
chips to leave out."""
import contextlib
from unittest import mock

import pytest
import torch

from perfbench import harness, run
from perfbench.conftest import tiny_cell

SEED = 2 ** 31 + 777


def _run(name):
    return run.run(tiny_cell(name), SEED, 0.5, False, "cpu", harness.Clock())


@contextlib.contextmanager
def solve_fault(kind):
    from fiode_tpu_torch.models import ivp
    real = ivp.odeint
    if kind == "unchanged":
        def odeint(f, y0, ts, **kw):
            sol = real(f, y0, ts, **kw)
            return sol._replace(ys=torch.stack([y0] * len(sol.ys)))
        with mock.patch.object(ivp, "odeint", odeint):
            yield
    elif kind == "half_batch":
        # half of the images solved, their endpoints copied to the rest
        def odeint(f, y0, ts, **kw):
            k = y0.shape[0] // 2
            sol = real(lambda t, h: f(t, torch.cat([h, h]))[:k], y0[:k], ts, **kw)
            return sol._replace(ys=torch.cat([sol.ys, sol.ys], 1))
        with mock.patch.object(ivp, "odeint", odeint):
            yield
    else:
        def odeint(f, y0, ts, **kw):
            sol = real(f, y0, ts, **kw)
            ys = sol.ys.clone()
            ys[-1, 0, 0] += 1e-2
            return sol._replace(ys=ys)
        with mock.patch.object(ivp, "odeint", odeint):
            yield


@contextlib.contextmanager
def crown_fault(kind):
    from fiode_tpu_torch.verify import certify
    real = certify.Certifier.crown_block
    if kind == "unchanged":
        def block(self, x_biases, labels, perms, etas, valids, worst):
            return worst
    elif kind == "half_batch":
        def block(self, x_biases, labels, perms, etas, valids, worst):
            half = torch.arange(etas.shape[1]) < etas.shape[1] // 2
            return real(self, x_biases, labels, perms, etas,
                        valids & half.to(valids.device), worst)
    else:
        def block(self, *args):
            return real(self, *args) + 1e-2
    with mock.patch.object(certify.Certifier, "crown_block", block):
        yield


@contextlib.contextmanager
def train_fault(kind):
    from fiode_tpu_torch.train import trainer
    if kind == "unchanged":
        def update(self):
            self.opt_count += 1
        with mock.patch.object(trainer.LyapunovTrainer, "_update", update):
            yield
        return
    real = trainer.lyapunov_loss

    def loss(*, h, f, y, **kw):
        if kind == "half_batch":
            k = h.shape[0] // 2
            return real(h=h[:k], f=f[:k], y=y[:k], **kw)
        out, metrics = real(h=h, f=f, y=y, **kw)
        return out * 1.01, metrics
    with mock.patch.object(trainer, "lyapunov_loss", loss):
        yield


FAULTS = {"ode-solve-b32768": solve_fault, "crown-certify-t40": crown_fault,
          "lyapunov-train-b128": train_fault}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_a_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in
                                   tiny_cell(name)["end_to_end"]}


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("name", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(name, kind):
    with FAULTS[name](kind):
        res = _run(name)
    assert not res["correct"], res["checks"]
