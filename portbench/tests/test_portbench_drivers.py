"""Each driver at a tiny size on the CPU (the kernels' plain versions),
sound and with its timed path broken underneath: a sound run is
``correct``; each fault the cell can have makes it not correct."""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.tests import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["crag_train", "glas_predict",
                                  "crag_pixel_tile"])
def test_sound_run_is_correct(name):
    res = run.run_cell(tiny.cell(name), 2**31 + 5, 0.1, False, CPU)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def _frozen_sgd(config, model):
    class Frozen(torch.optim.SGD):
        def step(self, closure=None):
            return None

    return Frozen(list(model.parameters()), lr=config.lr,
                  momentum=config.momentum, weight_decay=config.weight_decay)


def _broken_train(monkeypatch, fault):
    from wesup_tpu_torch.models import steps

    if fault == "state_unchanged":
        monkeypatch.setattr(steps, "make_optimizer", _frozen_sgd)
    elif fault == "half_batch":
        real = steps._forward_and_loss

        def half(model, prep, K, config, sample_valid, *a, **kw):
            keep = sample_valid.clone()
            rows = torch.nonzero(keep).flatten()
            keep[rows[max(1, len(rows) // 2):]] = False
            return real(model, prep, K, config, keep, *a, **kw)

        monkeypatch.setattr(steps, "_forward_and_loss", half)


def _train_cell():
    cell = tiny.cell("crag_train")
    cell["traffic"].update(batch_size=4)
    return cell


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_train_fault_is_caught(monkeypatch, fault):
    _broken_train(monkeypatch, fault)
    res = run.run_cell(_train_cell(), 2**31 + 5, 0.1, False, CPU)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_train_fault_only_in_the_window_is_caught(monkeypatch, fault):
    """A fault that begins once set-up is over, as a path taken only in
    steady state would, fails the check of the window's own steps."""
    from portbench.drivers import train

    real_setup = train.Driver.setup

    def setup(self):
        real_setup(self)
        if fault == "state_unchanged":
            self.trainer.optimizer.step = lambda closure=None: None
        else:
            _broken_train(monkeypatch, fault)

    monkeypatch.setattr(train.Driver, "setup", setup)
    res = run.run_cell(_train_cell(), 2**31 + 5, 0.1, False, CPU)
    assert not res["correct"], res["checks"]
    assert res["checks"]["grad_diff"]["value"] <= \
        res["checks"]["grad_diff"]["limit"]


def test_tile_altered_answer_is_caught(monkeypatch):
    from wesup_tpu_torch.models import wesup

    real = wesup.forward_pixel

    def altered(*a, **kw):
        probs = real(*a, **kw)
        probs[:, :4, :4] = probs[:, :4, :4].flip(-1)
        return probs

    monkeypatch.setattr(wesup, "forward_pixel", altered)
    res = run.run_cell(tiny.cell("crag_pixel_tile"), 7, 0.1, False, CPU)
    assert not res["correct"], res["checks"]


def test_predict_altered_answer_is_caught(monkeypatch):
    from wesup_tpu_torch.models import wesup

    real = wesup.forward_superpixel

    def altered(*a, **kw):
        out = real(*a, **kw)
        return out._replace(pred=1.0 - out.pred)

    monkeypatch.setattr(wesup, "forward_superpixel", altered)
    res = run.run_cell(tiny.cell("glas_predict"), 7, 0.1, False, CPU)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["crag_train", "glas_predict",
                                  "crag_pixel_tile"])
def test_control_fails_on_the_card(monkeypatch, name):
    """The control (the reference in float8 in the program's place) is
    not correct by ``run.run_cell`` at a size a test run holds: the
    cell's own widths, fewer images."""
    cell = tiny.cell(name)
    cell["config"] = tiny.spec.resolve(tiny.spec.load_benchmark(),
                                       name)["config"]
    cell["config"]["protocol"].update(n_train=24, n_test=8)
    cell["traffic"].update(batch_size=8, max_batch=8, pool=1, chunk=8,
                           check_slides=1, warm_epochs=1, check_steps=2)
    from portbench.reference.model import fp8

    real = cell["driver"].Driver.readings
    monkeypatch.setattr(cell["driver"].Driver, "readings",
                        lambda self: real(self, quant=fp8))
    res = run.run_cell(cell, 2**31 + 3, 1.0, False, torch.device("cuda"))
    assert not res["correct"], res["checks"]
