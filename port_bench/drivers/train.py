"""BC training: the inner loop of the port's trainer (``train/bc.py``)
on one scene's embedded dataset held on the device: start indices by
``sample_with_minimum_distance``, the unrolls by ``gather_unrolls``, one
``bc_step.make_train_step`` step, with no eval and no sync a step.

Set-up: the dataset and the policy's weights drawn from the seed on the
device; one ``TrainState`` (the policy, RMSprop's state at zero, the
action generator), driven through the window's own call for the checked
first steps, which also warm up every shape; then the window continues
from that same state.  Window: steps until ``seconds`` have passed and
the window's checked steps are done, then one sync; the B x T frames of
every step count.  Check: each checked step's loss, the first step's
clipped gradient (worked out from RMSprop's square average after one
step) and the parameters' change over the checked steps, leaf by leaf,
against the plain reference training from the seed's weights on the
same unrolls; then the same of as many steps inside the window, from a
step drawn from the seed, against the reference replayed from a copy of
the program's parameters and square average taken before that step.
Whatever the benchmark keeps of the program's state or outputs it
copies, so that a program that updates its tensors in place is read as
it was at each point.
"""

import contextlib
import random
import statistics
import time
from types import SimpleNamespace

import torch

from port_bench import harness, inputs
from port_bench.reference import policy as ref_policy
from port_bench.reference import precision
from pvr_habitat_tpu_torch.data import sampler
from pvr_habitat_tpu_torch.train import bc_step, optim


def run(ctx):
    pol = dict(ctx.config["policy"], unroll=ctx.traffic["unroll"])
    b, t = ctx.traffic["batch"], ctx.traffic["unroll"]
    dev = ctx.device
    data = inputs.bc_dataset(ctx.traffic, pol["obs_size"],
                             pol["num_actions"], ctx.seed, dev)
    n = data["obs"].shape[0]
    opt = optim.RMSpropTorch(
        pol["learning_rate"], alpha=pol["alpha"], eps=pol["epsilon"],
        max_epochs=pol["max_frames"] // (b * t) + 1)
    generator = torch.Generator(device=dev)
    generator.manual_seed(inputs.subseed(ctx.seed, "actions"))
    # the program's own weights; the reference draws its copy afterwards
    w_prog = inputs.policy_weights(pol, ctx.seed, dev)
    state = bc_step.TrainState(w_prog, {}, opt.init(w_prog), generator)
    del w_prog
    step_fn = ctx.hook("train_step", bc_step.make_train_step(
        opt, batch_norm=pol["batch_norm"],
        max_grad_norm=pol["max_grad_norm"]))
    rng = random.Random(inputs.subseed(ctx.seed, "starts"))
    spans = ctx.spans
    span = spans.span if spans is not None else (
        lambda name: contextlib.nullcontext())

    def train_once(state):
        with span("sample"):
            starts = sampler.sample_with_minimum_distance(n=n, k=b, d=t,
                                                          rng=rng)
            batch = sampler.gather_unrolls(data, starts, t)
        with span("step"):
            state, metrics = step_fn(
                state, {k: v.to(dev) for k, v in batch.items()})
        return state, metrics["loss"].detach().clone(), starts

    checked = ctx.traffic["checked_steps"]
    setup = dict(starts=[], loss=[])
    for k in range(checked):
        state, loss, starts = train_once(state)
        setup["starts"].append(starts)
        setup["loss"].append(loss)
        if k == 0:
            setup["square_1"] = _copy(state.opt_state.square_avg)
    setup["params"] = _copy(state.params)
    ctx.setup_done()

    lo, hi = ctx.traffic["window_check"]
    at = random.Random(inputs.subseed(ctx.seed, "window_check")) \
        .randrange(lo, hi)
    window = dict(starts=[], loss=[], first_step=checked + at)
    sl = ctx.profile_slice(1, ctx.traffic["profile_steps"])
    window_losses, steps = [], 0
    start = time.perf_counter()
    while True:
        if steps == at:
            window["params_0"] = _copy(state.params)
            window["square_0"] = _copy(state.opt_state.square_avg)
        if sl:
            sl.before(steps)
        state, loss, starts = train_once(state)
        if sl:
            sl.after(steps)
        window_losses.append(loss)
        if at <= steps < at + checked:
            window["starts"].append(starts)
            window["loss"].append(loss)
            if steps == at:
                window["square_1"] = _copy(state.opt_state.square_avg)
            if steps == at + checked - 1:
                window["params"] = _copy(state.params)
        steps += 1
        if ctx.window_done(time.perf_counter() - start) \
                and steps >= at + checked:
            break
    harness.sync(dev)
    elapsed = time.perf_counter() - start
    rate = steps * b * t / elapsed
    memory = ctx.memory_peak()
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    del state, window_losses
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    w0 = inputs.policy_weights(pol, ctx.seed, dev)
    square_0 = {k: torch.zeros_like(v) for k, v in w0.items()}
    prog = _program_numbers(setup, square_0, pol)
    prog_w = _program_numbers(window, window["square_0"], pol)
    with precision(tf32=False):
        ref = ref_policy.train(w0, data, setup["starts"], pol)
        ref_w = ref_policy.train(window["params_0"], data, window["starts"],
                                 pol, square=window["square_0"],
                                 first_step=window["first_step"])
    reading = None
    if sl:
        reading = SimpleNamespace(
            host=spans.host, calls=spans.calls,
            prof=sl.reading(),
            items=sl.items(), frames_per_item=b * t,
            item_s=sl.item_s(steps, elapsed))
    numbers = dict(compare(prog, ref, w0),
                   **compare(prog_w, ref_w, window["params_0"], "window_"))
    return dict(
        e2e={"train_frames_per_s": rate}, attempted=steps, failed=failed,
        memory_peak_bytes=memory, reading=reading,
        info={"dataset_rows": n, "window_steps": steps,
              "window_check_step": window["first_step"]},
        numbers=numbers,
        checks={name: (numbers[name], limit) for name, limit
                in ctx.cell["correct"]["limits"].items()},
        control=lambda: control(w0, data, setup["starts"], pol, ref,
                                window, ref_w))


def _copy(tensors):
    return {k: v.detach().clone() for k, v in tensors.items()}


def _program_numbers(steps, square_0, pol):
    """dict(loss, first_grads, params) of the program's checked steps:
    the first step's clipped gradient from RMSprop's square average
    before and after it."""
    alpha = pol["alpha"]
    return dict(
        loss=[float(x) for x in steps["loss"]],
        first_grads={k: torch.sqrt(torch.clamp(
            (v - alpha * square_0[k]) / (1 - alpha), min=0))
            for k, v in steps["square_1"].items()},
        params=steps["params"])


def _leaf_gaps(prog_norms, ref_norms):
    """Each leaf's | |prog| - |ref| |, over the larger of that leaf's
    reference norm and the median leaf's."""
    median = statistics.median(ref_norms.values())
    return [abs(prog_norms[k] - r) / max(r, median, 1e-30)
            for k, r in ref_norms.items()]


def compare(prog, ref, w0, prefix=""):
    """Numbers of the checked steps.  ``prog`` and ``ref``: dict(loss,
    first_grads, params); ``w0`` the parameters before them.  The losses'
    worst relative gap (and the first step's alone); the first clipped
    gradient's and the parameters' change's norms leaf by leaf, by the
    worst leaf and the median one."""
    loss = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    grad_ref = {k: float(torch.linalg.norm(g))
                for k, g in ref["first_grads"].items()}
    grad_prog = {k: float(torch.linalg.norm(g))
                 for k, g in prog["first_grads"].items()}
    # leaves whose reference gradient is nought to rounding (the baseline
    # head is outside the loss) move by round-off alone: not compared
    floor = 1e-3 * statistics.median(grad_ref.values())
    moved = [k for k, g in grad_ref.items() if g >= floor]
    change_ref = {k: float(torch.linalg.norm(ref["params"][k] - w0[k]))
                  for k in moved}
    change_prog = {k: float(torch.linalg.norm(prog["params"][k] - w0[k]))
                   for k in moved}
    grad = _leaf_gaps(grad_prog, grad_ref)
    change = _leaf_gaps(change_prog, change_ref)
    numbers = {"loss_gap": max(loss), "loss_gap_first": loss[0],
               "grad_norm_gap": max(grad),
               "grad_norm_gap_median": statistics.median(grad),
               "change_gap": max(change),
               "change_gap_median": statistics.median(change)}
    return {prefix + k: v for k, v in numbers.items()}


def control(w0, data, starts, pol, ref, window, ref_w):
    """The control's numbers: the reference in TF32 in the program's
    place, from the seed's weights and from the window's snapshot."""
    with precision(tf32=True):
        low = ref_policy.train(w0, data, starts, pol)
        low_w = ref_policy.train(window["params_0"], data, window["starts"],
                                 pol, square=window["square_0"],
                                 first_step=window["first_step"])
    return dict(compare(low, ref, w0),
                **compare(low_w, ref_w, window["params_0"], "window_"))
