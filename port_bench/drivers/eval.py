"""Online eval at one env: a closed loop of FakeNav steps (the hermetic
stand-in for habitat-sim's renderer) with the frozen encoder inside the
env's ``EmbeddingWrapper`` at batch 1, then the policy's
``PolicyRunner`` step, over whole episodes, resets included.

Set-up: the encoder's and the policy's weights drawn from the seed on
the device, an ``EmbeddingNet`` on its card default route, the env
stack of the port's factory, and warm-up steps of the same loop.
Window: from a fresh episode and a zero LSTM state, env steps until
``seconds`` have passed; each step (the policy step and the env step
that follows it) is one sample of the latency.  Check: the reference
embeds every frame the env rendered in the window and runs the policy
over them and the episodes' resets from the same zero state; the
program's embeddings, its actions (by the gap of each chosen action's
reference logit below the reference's best) and its final LSTM state
are held against it.  The reference draws its own copy of the seed's
weights, and what the benchmark keeps of each step is a copy.
"""

import contextlib
import statistics
import time
from types import SimpleNamespace

import numpy as np
import torch

from port_bench import harness, inputs
from port_bench.drivers import embed
from port_bench.reference import encoder as ref_encoder
from port_bench.reference import policy as ref_policy
from port_bench.reference import precision
from pvr_habitat_tpu_torch.envs import api
from pvr_habitat_tpu_torch.envs.environment import Environment
from pvr_habitat_tpu_torch.envs.make_env import make_gym_env
from pvr_habitat_tpu_torch.train.evaluate import PolicyRunner
from pvr_habitat_tpu_torch.utils.flags import default_flags


# Leads of the reference's best action under which a served action may
# differ from it: float32 rounding decides such near-ties.
TIE = 1e-4


class FrameTap(api.Wrapper):
    """Keeps the last raw frame the simulator rendered, for the check."""

    last = None

    def reset(self):
        self.last = self.env.reset()
        return self.last

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        self.last = obs
        return obs, reward, done, info


class TimedEncoder:
    """The wrapper env's encoder call inside an ``encoder`` span."""

    def __init__(self, net, spans):
        self.net, self.spans = net, spans
        self.out_size = net.out_size

    def __call__(self, frames):
        with self.spans.span("encoder"):
            return self.net(frames)


def run(ctx):
    enc, dev = ctx.config["encoder"], ctx.device
    pol = ctx.config["policy"]
    dtype = getattr(torch, ctx.cell["precision"])
    net = embed.build(ctx, dtype)
    runner = ctx.hook("policy", PolicyRunner(
        inputs.policy_weights(pol, ctx.seed, dev), {},
        batch_norm=pol["batch_norm"]))
    logits = []                        # the policy step's, copied on the device
    apply_fn = runner.apply_fn

    def keep_logits(*args, **kwargs):
        out = apply_fn(*args, **kwargs)
        logits.append(out[0]["policy_logits"].detach().clone())
        return out
    runner.apply_fn = keep_logits
    flags = default_flags(env=ctx.traffic["env"],
                          embedding_name=enc["embedding_name"])
    gym_env = make_gym_env(flags, net,
                           seed=inputs.subseed(ctx.seed, "env") % 2 ** 31)
    tap = FrameTap(gym_env.env)        # under the EmbeddingWrapper
    gym_env.env = tap
    env = Environment(gym_env)

    spans = ctx.spans
    span = spans.span if spans is not None else (
        lambda name: contextlib.nullcontext())

    def loop(steps=None, record=None, times=None):
        env_out = env.initial()
        state = runner.initial_state(1)
        k, start = 0, time.perf_counter()
        while True:
            if record is not None:
                record["frame"].append(np.array(tap.last))
                record["obs"].append(np.array(env_out["obs"]))
                record["done"].append(np.array(env_out["done"]))
            if sl and times is not None:
                sl.before(k)
            t0 = time.perf_counter()
            with span("policy"):
                out, state = runner(env_out, state)
            with span("env_step"):
                env_out = env.step(out["action"])
            t1 = time.perf_counter()
            if sl and times is not None:
                sl.after(k)
            k += 1
            if record is not None:
                record["action"].append(int(np.asarray(out["action"])
                                            .reshape(-1)[0]))
                times.append(t1 - t0)
                if ctx.window_done(t1 - start):
                    return state
            elif k >= steps:
                return state

    sl = None
    loop(steps=ctx.traffic["warm_steps"])
    ctx.setup_done()

    sl = ctx.profile_slice(ctx.traffic["profile_from"],
                          ctx.traffic["profile_steps"])
    record = {"frame": [], "obs": [], "done": [], "action": []}
    times = []
    del logits[:]
    with contextlib.ExitStack() as stack:
        if spans is not None:
            stack.enter_context(harness.patched(
                gym_env, "embedding", TimedEncoder(net, spans)))
            embed.trace_kernels(stack, spans)
        state = loop(record=record, times=times)
    p95_ms = statistics.quantiles(times, n=20)[18] * 1e3
    memory = ctx.memory_peak()
    final = tuple(s.detach().clone() for s in state)
    del net, runner, state
    env.close()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    frames = torch.as_tensor(np.stack(record["frame"])).to(dev)
    done = torch.as_tensor(np.concatenate(record["done"])).to(dev)
    enc_weights = inputs.encoder_weights(enc, ctx.seed, dev)
    pol_weights = inputs.policy_weights(pol, ctx.seed, dev)
    prog = dict(emb=torch.as_tensor(np.concatenate(record["obs"])
                                    .reshape(len(times), -1)),
                logits=torch.cat(logits).reshape(len(times), -1).cpu(),
                action=torch.as_tensor(record["action"]), state=final)
    ref = reference(frames, done, enc_weights, pol_weights, enc, pol,
                    tf32=False)
    reading = None
    if sl:
        reading = SimpleNamespace(
            host=spans.host, calls=spans.calls,
            prof=sl.reading(),
            items=sl.items(), frames_per_item=1,
            item_s=_mean(times[:sl.first] + times[sl.first + 2 * sl.count:]))
    numbers = compare(prog, ref)
    return dict(
        e2e={"eval_step_ms_p95": p95_ms}, attempted=len(times),
        failed=int((~torch.isfinite(prog["emb"]).all(dim=1)).sum()),
        memory_peak_bytes=memory, reading=reading,
        info={"steps": len(times), "episodes": int(done.sum()) + 1,
              "median_ms": statistics.median(times) * 1e3},
        numbers=numbers,
        checks={name: (numbers[name], limit) for name, limit
                in ctx.cell["correct"]["limits"].items()},
        control=lambda: control(frames, done, enc_weights, pol_weights,
                                enc, pol, ref))


def _mean(times):
    return statistics.fmean(times) if times else None


@torch.no_grad()
def reference(frames, done, enc_weights, pol_weights, enc, pol, tf32):
    """Embeddings, logits (T, A), the argmax actions and the final state
    of the plain reference over the window's frames and resets."""
    with precision(tf32=tf32):
        emb = ref_encoder.embed(frames, enc_weights, enc)
        logits, state = ref_policy.forward(
            pol_weights, emb[:, None], done,
            ref_policy.zero_state(pol, 1, emb.device), pol)
    logits = logits[:, 0]
    return dict(emb=emb.cpu(), logits=logits.cpu(),
                action=logits.argmax(dim=-1).cpu(), state=state)


def compare(prog, ref):
    """Numbers of the window's steps against the reference's: the worst
    step's embedding error (``emb_err``), the worst step's largest logit
    error over the logits' RMS (``logit_err``), the final LSTM state's
    error (``state_err``), and, exactly, the steps whose served action is
    not the reference's best where the reference's best leads the next
    by more than ``TIE`` of the logits' RMS (``action_mismatch``); the
    widest gap of a served action's reference logit below the best is
    kept as ``action_gap``."""
    emb_err = float(harness.rel_err_rows(prog["emb"], ref["emb"]).max())
    scale = float(ref["logits"].double().pow(2).mean().sqrt())
    logit_err = float((prog["logits"].double() - ref["logits"].double())
                      .abs().max()) / scale
    top2 = ref["logits"].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TIE * scale
    mismatch = int(((prog["action"] != ref["action"]) & clear).sum())
    chosen = ref["logits"].gather(1, prog["action"].long()[:, None])[:, 0]
    gap = float((ref["logits"].max(dim=-1).values - chosen).max())
    state_err = max(
        float(torch.linalg.norm((p.double() - r.double()).cpu())
              / torch.linalg.norm(r.double().cpu()).clamp_min(1e-30))
        for p, r in zip(prog["state"], ref["state"]))
    return {"emb_err": emb_err, "logit_err": logit_err,
            "state_err": state_err, "action_mismatch": mismatch,
            "action_gap": gap}


def control(frames, done, enc_weights, pol_weights, enc, pol, ref):
    """The control's numbers: the reference in TF32 in the program's
    place."""
    low = reference(frames, done, enc_weights, pol_weights, enc, pol,
                    tf32=True)
    return compare(low, ref)
