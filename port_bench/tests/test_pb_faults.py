"""A run with its timed path broken underneath, the look for a chip
skipped, comes out not correct: once for each fault the cell can have
(``faults.py``).  No cell runs across chips, so none can leave an
exchange out.  A program that updates its own tensors in place is read
as it was at each point, and the reference draws its own weights: a
sound program that reuses its tensors in place stays correct."""

import pytest
import torch

from port_bench import faults, harness

from .conftest import TINY

CASES = [(cell, fault) for cell in TINY for fault in faults.FAULTS
         if faults.hooks(harness.cell_files(cell)[2]["driver"], fault)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails_the_check(tiny_run, cell, fault):
    driver = harness.cell_files(cell)[2]["driver"]
    result = tiny_run(cell, hooks=faults.hooks(driver, fault), seconds=0.5)
    over = {name: value for name, (value, limit) in result["checks"].items()
            if not value <= limit}
    assert over, result["checks"]


def test_every_cell_has_faults():
    assert {cell for cell, _ in CASES} == set(TINY)


def _in_place(step, ctx):
    """A sound train step that writes the new parameters, square average
    and loss into the tensors it was given, as an in-place optimizer or
    a captured graph's static buffers would."""
    loss = []

    def step_in_place(state, batch):
        new, metrics = step(state, batch)
        with torch.no_grad():
            for old, now in ((state.params, new.params),
                             (state.opt_state.square_avg,
                              new.opt_state.square_avg)):
                for k, v in now.items():
                    old[k].copy_(v)
            if loss:
                loss[0].copy_(metrics["loss"])
            else:
                loss.append(metrics["loss"].detach().clone())
        kept = new._replace(params=state.params, opt_state=new.opt_state
                            ._replace(square_avg=state.opt_state.square_avg))
        return kept, dict(metrics, loss=loss[0])
    return step_in_place


def test_in_place_train_step_stays_correct(tiny_run):
    result = tiny_run("train.resnet50.b32t100",
                      hooks={"train_step": _in_place})
    over = {name: value for name, (value, limit) in result["checks"].items()
            if not value <= limit}
    assert not over, result["checks"]


def _weights_reused(net, ctx):
    """A sound program that moves its weights into tensors of its own
    and reuses the ones it was handed (here: zeroes them)."""
    handed = net.handle.params
    own = {k: v.clone() for k, v in handed.items()}
    if net.params is handed:
        net.params = own
    net.handle.params = own
    with torch.no_grad():
        for v in handed.values():
            v.zero_()
    return net


@pytest.mark.parametrize("cell", [c for c in TINY
                                  if not c.startswith("train.")])
def test_weights_reused_in_place_stay_correct(tiny_run, cell):
    result = tiny_run(cell, hooks={"encoder": _weights_reused})
    over = {name: value for name, (value, limit) in result["checks"].items()
            if not value <= limit}
    assert not over, result["checks"]
