"""The train step replayed from a CUDA graph (``train/bc_step.py::
make_train_step``) and the optimizer's lr as a device tensor.

On the CPU: the tensor lr gives the host float's updates bit for bit,
the step stays eager where it cannot be captured, and the signature
separates batches one graph cannot serve.  On the card (marker
``cuda``): the graphed step against the eager ``step_body`` from the
same state.  Imports no JAX, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_graphed_step.py

Without a CUDA device the ``cuda`` tests skip."""

import numpy as np
import pytest
import torch

from pvr_habitat_tpu_torch.parallel.mesh import Mesh
from pvr_habitat_tpu_torch.train import bc_step, optim
from pvr_habitat_tpu_torch.utils import profiling
from pvr_habitat_tpu_torch.utils.flags import default_flags

ACTIONS = 3


def _host_float_update(opt, grads, state):
    """``RMSpropTorch.update`` with the lr a host float, as before it
    took a tensor."""
    sq = {k: opt.alpha * state.square_avg[k] + (1.0 - opt.alpha) * g * g
          for k, g in grads.items()}
    step_dir = {k: g / (torch.sqrt(sq[k]) + opt.eps)
                for k, g in grads.items()}
    buf = ()
    if opt.momentum:
        buf = {k: opt.momentum * state.momentum_buf[k] + d
               for k, d in step_dir.items()}
        step_dir = buf
    lr = float(opt.lr(state.count))
    return {k: -lr * d for k, d in step_dir.items()}, sq, buf


@pytest.mark.parametrize("count", [0, 1, 10 ** 4])
@pytest.mark.parametrize("max_epochs", [None, 30000])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_tensor_lr_update_is_bit_identical(momentum, max_epochs, count):
    g = torch.Generator().manual_seed(count + 7)
    shapes = {"a": (64, 33), "b": (33,), "c": (5, 4, 3)}
    grads = {k: torch.randn(s, generator=g) * 10.0 ** -(i + 2)
             for i, (k, s) in enumerate(shapes.items())}
    opt = optim.RMSpropTorch(1e-4, alpha=0.99, eps=1e-5, momentum=momentum,
                             max_epochs=max_epochs)
    state = opt.init(grads)._replace(
        count=count,
        square_avg={k: torch.rand(s, generator=g) * 1e-6
                    for k, s in shapes.items()})
    if momentum:
        state = state._replace(momentum_buf={
            k: torch.randn(s, generator=g) for k, s in shapes.items()})
    want, want_sq, want_buf = _host_float_update(opt, grads, state)
    # the lr a new tensor (eager) and a buffer filled in place (graphed)
    buffer = torch.zeros((), dtype=torch.float32)
    buffer.fill_(float(opt.lr(count)))
    for lr in (None, buffer):
        updates, new = opt.update(grads, state, lr)
        assert new.count == count + 1
        for k in shapes:
            assert torch.equal(updates[k], want[k]), k
            assert torch.equal(new.square_avg[k], want_sq[k]), k
            if momentum:
                assert torch.equal(new.momentum_buf[k], want_buf[k]), k
        assert new.momentum_buf == () or momentum


@pytest.mark.parametrize("device,mesh,graphed", [
    ("cpu", None, False),
    ("cpu", Mesh(1, 1), False),
    ("cuda", Mesh(2, 1), False),
    ("cuda", Mesh(1, 2), False),
    ("cuda", Mesh(2, 2), False),
    ("cuda", None, True),
    ("cuda", Mesh(1, 1), True),
])
def test_captures_only_on_one_cuda_rank(device, mesh, graphed):
    assert bc_step.captures(torch.device(device), mesh) is graphed


def _cpu_state(seed, obs=16, momentum=0.0):
    flags = default_flags(momentum=momentum)
    return bc_step.create_train_state(
        np.random.RandomState(seed), (obs,), ACTIONS, flags, max_epochs=50,
        seed=seed, device="cpu")


def _batch(t, b, obs_shape, seed, device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.uint8:
        obs = torch.randint(0, 256, (t, b) + obs_shape, generator=g,
                            dtype=torch.uint8)
    else:
        obs = torch.randn((t, b) + obs_shape, generator=g).to(dtype)
    return {k: v.to(device) for k, v in dict(
        obs=obs,
        action=torch.randint(0, ACTIONS, (t, b), generator=g),
        done=torch.rand((t, b), generator=g) < 0.1).items()}


@pytest.mark.parametrize("mesh", [None, Mesh(1, 1)], ids=["none", "1x1"])
def test_cpu_step_is_eager_and_makes_no_graph(monkeypatch, mesh):
    def refuse(*args, **kwargs):
        raise AssertionError("a graph was made for a CPU batch")

    monkeypatch.setattr(bc_step, "_GraphedStep", refuse)
    state, opt = _cpu_state(1)
    want_state, _ = _cpu_state(1)
    step = bc_step.make_train_step(opt, mesh=mesh)
    for k in range(2):
        batch = _batch(5, 4, (16,), seed=k)
        state, metrics = step(state, batch)
        want_state, want = bc_step.step_body(want_state, batch, opt)
        assert torch.equal(metrics["loss"], want["loss"])
        assert torch.equal(metrics["gradient_norm"], want["gradient_norm"])
    for key, value in want_state.params.items():
        assert torch.equal(state.params[key], value), key
    assert state.opt_state.count == 2


@pytest.mark.parametrize("change", [
    "same", "strided_view", "B", "T", "obs_width", "obs_dtype",
    "action_dtype", "generator", "params"])
def test_signature_separates_what_one_graph_cannot_serve(change):
    state, _ = _cpu_state(0)
    batch = _batch(6, 4, (16,), seed=0)
    other_state, other = state, dict(batch)
    if change == "strided_view":
        wide = _batch(6, 8, (16,), seed=1)
        other = {k: v[:, ::2] for k, v in wide.items()}
    elif change == "B":
        other = _batch(6, 2, (16,), seed=0)
    elif change == "T":
        other = _batch(5, 4, (16,), seed=0)
    elif change == "obs_width":
        other = _batch(6, 4, (18,), seed=0)
    elif change == "obs_dtype":
        other["obs"] = batch["obs"].to(torch.float64)
    elif change == "action_dtype":
        other["action"] = batch["action"].int()
    elif change == "generator":
        other_state = state._replace(generator=torch.Generator())
    elif change == "params":
        other_state, _ = _cpu_state(0, obs=18)
    same = bc_step.signature(state, batch) == bc_step.signature(other_state,
                                                                other)
    assert same is (change in ("same", "strided_view"))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    """f32 with TF32 off, as the trainer runs; cuDNN's deterministic
    algorithms, since its default weight-gradient ones sum with atomics
    and part two eager steps of the conv policy from one state by up to
    1e-5 (RMSprop turns round-off in a small gradient into a step of
    about the lr): the graph is held to the eager step bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


# (policy, obs shape, batch norm, momentum, B, T, steps): the MLP at the
# trainer's size, with and without BatchNorm and momentum; the conv
# policy small
CASES = {
    "mlp": ("mlp", (2048,), False, 0.0, 32, 100, 5),
    "mlp_bn_momentum": ("mlp", (2048,), True, 0.9, 32, 100, 5),
    "conv_bn": ("conv", (32, 24, 6), True, 0.0, 4, 10, 3),
}


def _card_state(case, device, max_epochs=100):
    policy, obs_shape, batch_norm, momentum, *_ = case
    flags = default_flags(momentum=momentum, batch_norm=batch_norm)
    return bc_step.create_train_state(
        np.random.RandomState(3), obs_shape, ACTIONS, flags,
        conv_policy=policy == "conv", max_epochs=max_epochs, seed=5,
        device=device)


def _step_kw(case, flags_grad_norm=40.0):
    policy, _, batch_norm, *_ = case
    return dict(batch_norm=batch_norm, conv_policy=policy == "conv",
                max_grad_norm=flags_grad_norm)


def _assert_states_equal(got, want):
    for part, tensors in bc_step._state_tensors(want).items():
        assert torch.equal(bc_step._state_tensors(got)[part], tensors), part
    assert got.opt_state.count == want.opt_state.count
    assert torch.equal(got.generator.get_state(), want.generator.get_state())


class _Spy:
    """Counts the graphs ``make_train_step`` makes."""

    def __init__(self, monkeypatch):
        self.made = 0
        real = bc_step._GraphedStep

        def make(*args):
            self.made += 1
            return real(*args)

        monkeypatch.setattr(bc_step, "_GraphedStep", make)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_graphed_steps_equal_eager(card, monkeypatch, name):
    case = CASES[name]
    policy, obs_shape, _, _, b, t, steps = case
    dtype = torch.uint8 if policy == "conv" else torch.float32
    spy = _Spy(monkeypatch)
    graphed, opt = _card_state(case, card)
    eager, _ = _card_state(case, card)
    step = bc_step.make_train_step(opt, **_step_kw(case))
    for k in range(steps):
        batch = _batch(t, b, obs_shape, seed=k, device=card, dtype=dtype)
        before = {key: v.clone()
                  for key, v in bc_step._state_tensors(graphed).items()}
        kept = bc_step._state_tensors(graphed)
        graphed, metrics = step(graphed, batch)
        eager, want = bc_step.step_body(eager, batch, opt, **_step_kw(case))
        for key in ("loss", "gradient_norm"):
            assert torch.equal(metrics[key], want[key]), (k, key)
        _assert_states_equal(graphed, eager)
        # the caller's tensors are as they were
        for key, value in before.items():
            assert torch.equal(kept[key], value), (k, key)
    assert spy.made == 1


@pytest.mark.cuda
def test_two_signatures_each_capture_and_interleave(card, monkeypatch):
    case = CASES["mlp"]
    spy = _Spy(monkeypatch)
    graphed, opt = _card_state(case, card)
    eager, _ = _card_state(case, card)
    step = bc_step.make_train_step(opt, **_step_kw(case))
    for k, half in enumerate([False, True, False, True, True, False]):
        batch = _batch(100, 32, (2048,), seed=k, device=card)
        if half:         # the columns of a view, as the half-batch fault
            batch = {key: v[:, :16] for key, v in batch.items()}
        graphed, metrics = step(graphed, batch)
        eager, want = bc_step.step_body(eager, batch, opt, **_step_kw(case))
        for key in ("loss", "gradient_norm"):
            assert torch.equal(metrics[key], want[key]), (k, key)
        _assert_states_equal(graphed, eager)
    assert spy.made == 2


@pytest.mark.cuda
@pytest.mark.parametrize("count", [0, 1000])
def test_lr_schedule_in_the_graph(card, count):
    """With ``max_epochs``, the lr the host computes from the count
    reaches the graph's update: a step from count 1,000 after a capture
    at count 0 gives the eager update."""
    case = CASES["mlp"]
    graphed, opt = _card_state(case, card, max_epochs=1500)
    eager, _ = _card_state(case, card, max_epochs=1500)
    step = bc_step.make_train_step(opt, **_step_kw(case))
    # capture at count 0, then step from ``count``
    step(graphed, _batch(100, 32, (2048,), seed=9, device=card))

    def at(state):
        return state._replace(opt_state=state.opt_state._replace(count=count))

    batch = _batch(100, 32, (2048,), seed=0, device=card)
    graphed, _ = step(at(graphed), batch)
    eager, _ = bc_step.step_body(at(eager), batch, opt, **_step_kw(case))
    for key, value in eager.params.items():
        assert torch.equal(graphed.params[key], value), key
    assert graphed.opt_state.count == count + 1


@pytest.mark.cuda
def test_capture_under_the_profiler(card, tmp_path):
    """A trainer's ``--profile_dir`` trace can hold the first step: the
    capture under ``torch.profiler``, then replays; every call one
    ``train.step`` with one ``train.graph`` inside."""
    case = CASES["mlp"]
    state, opt = _card_state(case, card)
    step = bc_step.make_train_step(opt, **_step_kw(case))
    first = max((s.id for s in profiling.spans()), default=-1) + 1
    with profiling.trace(str(tmp_path)):
        for k in range(3):
            state, metrics = step(state, _batch(100, 32, (2048,), seed=k,
                                                device=card))
        torch.cuda.synchronize()
    names = [s.name for s in profiling.spans(first)]
    assert names.count("train.step") == 3
    assert names.count("train.graph") == 3
    assert torch.isfinite(metrics["loss"])
