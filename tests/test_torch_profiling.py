"""The port's spans (``utils/profiling.py``): off without a profiler, on
under one, at the layer boundaries of the bulk embedder, the pipeline and
the train step, on the profiler's clock and in ``trace``'s Chrome trace;
and ``StepTimer``'s training rate between report points."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pvr_habitat_tpu_torch.data import sampler
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.train import bc_step
from pvr_habitat_tpu_torch.utils import profiling
from pvr_habitat_tpu_torch.utils.flags import default_flags


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _since():
    """An id above every span recorded so far."""
    return max((s.id for s in profiling.spans()), default=-1) + 1


def _no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span opened a record_function")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_off_without_a_profiler(monkeypatch):
    _no_record_function(monkeypatch)
    before = len(profiling.spans())
    shapes = []
    with profiling.span("probe.off", shape=lambda: shapes.append(1)) as s:
        torch.ones(3).sum()
    assert s is None
    assert profiling.span("probe.off") is profiling.span("probe.other")
    assert len(profiling.spans()) == before
    assert shapes == []          # an attribute's callable is not called


def test_on_under_a_profiler(monkeypatch):
    _no_record_function(monkeypatch)
    first = _since()
    with _cpu_profile() as prof:
        with profiling.span("probe.outer", k=2, shape=lambda: {"n": 3}):
            with profiling.span("probe.inner"):
                torch.ones(3).sum()
    got = {s.name: s for s in profiling.spans(first)}
    outer, inner = got["probe.outer"], got["probe.inner"]
    assert outer.attrs == {"k": 2, "shape": {"n": 3}}
    assert inner.parent == outer.id and outer.parent is None
    assert outer.thread == inner.thread == threading.get_native_id()
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    # no profiler event of the program's spans
    assert not any(e.name.startswith("probe.") for e in prof.events())


def test_embed_batches_spans_by_batch_and_thread():
    net = EmbeddingNet("random", pretrained=False, device="cpu")
    frames = np.random.RandomState(0).randint(0, 255, (6, 32, 32, 3),
                                              np.uint8)
    net.embed_batches(frames[:2], 2)            # warm
    first = _since()
    with _cpu_profile():
        out = net.embed_batches(frames, 2)
    assert out.shape == (6, net.out_size)
    recorded = profiling.spans(first)
    names = [s.name for s in recorded]
    for name in ("embed.preprocess", "embed.encoder", "pipeline.stage",
                 "pipeline.wait_stage", "pipeline.dispatch",
                 "pipeline.wait_slot", "pipeline.fetch"):
        assert names.count(name) == 3, name
    threads = {name: {s.thread for s in recorded if s.name == name}
               for name in set(names)}
    main = threading.get_native_id()
    assert threads["pipeline.dispatch"] == threads["embed.encoder"] == {main}
    stager, fetcher = threads["pipeline.stage"], threads["pipeline.fetch"]
    assert len(stager) == len(fetcher) == 1
    assert len({main} | stager | fetcher) == 3
    by_id = {s.id: s for s in recorded}
    for s in recorded:
        if s.name in ("embed.preprocess", "embed.encoder"):
            assert by_id[s.parent].name == "pipeline.dispatch"


def test_train_step_spans_once_a_step():
    flags = default_flags()
    state, opt = bc_step.create_train_state(
        np.random.RandomState(2), (16,), 4, flags, max_epochs=10, seed=3,
        device="cpu")
    rng = np.random.RandomState(0)
    data = sampler.to_tensors(dict(
        obs=rng.randn(40, 16).astype(np.float32),
        action=rng.randint(0, 4, size=40).astype(np.int32),
        done=rng.rand(40) < 0.1), "cpu")
    step = bc_step.make_train_step(opt)
    first = _since()
    with _cpu_profile():
        for starts in ([0, 10], [5, 20]):
            state, _ = step(state, sampler.gather_unrolls(data, starts, 5))
    recorded = profiling.spans(first)
    names = [s.name for s in recorded]
    for name in ("data.gather", "train.forward", "train.backward",
                 "train.clip", "train.optimizer", "policy.lstm"):
        assert names.count(name) == 2, name
    by_id = {s.id: s for s in recorded}
    for s in recorded:
        if s.name == "policy.lstm":
            assert by_id[s.parent].name == "train.forward"
        elif s.name.startswith("train."):
            assert s.parent is None
    order = [n for n in names if n.startswith("train.")][:4]
    assert order == ["train.forward", "train.backward", "train.clip",
                     "train.optimizer"]


def test_kernel_spans_carry_the_call_shapes():
    """The kernel wrappers' spans record what the benchmark's rooflines
    read of each call, as its own wrappers record it."""
    from port_bench.drivers.embed import _attention_shape, _bottleneck_shape
    from pvr_habitat_tpu_torch.ops.cuda import attention, fused_bottleneck

    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g)

    x = rand(2, 8, 8, 16)
    w = (rand(16, 4), rand(4), rand(9, 4, 4), rand(4), rand(4, 32),
         rand(32), rand(16, 32), rand(32))
    q, k, v = rand(2, 3, 8, 16), rand(2, 3, 8, 16), rand(2, 3, 8, 16)
    first = _since()
    with _cpu_profile():
        fused_bottleneck.fused_bottleneck(x, *w, stride=2)
        attention.fused_attention(q, k, v)
    got = {s.name: s.attrs["shape"] for s in profiling.spans(first)}
    assert got["kernel.fused_bottleneck"] == _bottleneck_shape(x, *w,
                                                               stride=2)
    assert got["kernel.fused_attention"] == _attention_shape(q, k, v)


def test_span_on_the_profilers_clock():
    """A span's end, mapped onto the profiler's timeline, agrees with a
    ``record_function`` range closed right after it (the best of ten, so
    that a descheduled thread does not decide)."""
    first = _since()
    with _cpu_profile() as prof:
        for k in range(11):
            with torch.autograd.profiler.record_function(f"probe.rf{k}"):
                with profiling.span(f"probe.span{k}"):
                    torch.ones(8).sum()
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name.startswith("probe.rf")}
    gaps = []
    for s in profiling.spans(first):
        k = s.name[len("probe.span"):]
        if k == "0":
            continue                  # the first range pays for set-up
        rng = ranges[f"probe.rf{k}"]
        start = profiling.profiler_us(s.start_ns, prof)
        end = profiling.profiler_us(s.end_ns, prof)
        assert start <= end
        gaps.append(max(abs(rng.end - end), abs(start - rng.start)))
    assert len(gaps) == 10
    assert min(gaps) < 100.0, gaps


def test_trace_writes_the_spans(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("probe.traced", shape=lambda: {"n": 7}):
            with torch.autograd.profiler.record_function("probe.rf"):
                torch.ones(8).sum()
    doc = json.loads((tmp_path / "trace.json").read_text())
    events = doc["traceEvents"]
    mine = [e for e in events if e.get("name") == "probe.traced"]
    assert len(mine) == 1
    span = mine[0]
    assert span["ph"] == "X" and span["cat"] == "program_span"
    assert span["tid"] == threading.get_native_id()
    assert span["args"] == {"shape": {"n": 7}}
    rf = [e for e in events if e.get("name") == "probe.rf"][0]
    # the range inside the span lies inside it on the trace's timeline
    slack = 100.0
    assert span["ts"] - slack <= rf["ts"]
    assert rf["ts"] + rf["dur"] <= span["ts"] + span["dur"] + slack


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_step_timer_rate_between_reports():
    clock, lines = FakeClock(), []
    timer = profiling.StepTimer(items_per_step=10, label="train",
                                clock=clock)
    assert timer.report(lines.append) is None
    for _ in range(4):
        clock.now += 0.5
        timer.tick()
    assert timer.report(lines.append) == pytest.approx(0.5)
    clock.now += 100.0               # eval and checkpoint
    timer.restart()
    for _ in range(2):
        clock.now += 0.25
        timer.tick()
    assert timer.report(lines.append) == pytest.approx(0.25)
    assert lines == ["   train: 500.00 ms/iter, 20 items/s",
                     "   train: 250.00 ms/iter, 40 items/s"]


def test_bc_timer_leaves_out_eval(tmp_path, monkeypatch, capsys):
    """The trainer's timer line is the training rate: a step costs one
    second of the fake clock, an eval a thousand, and every report reads
    1000 ms a step."""
    from pvr_habitat_tpu_torch import main_bc_2
    from pvr_habitat_tpu_torch.tools import save_embedded_obs
    from pvr_habitat_tpu_torch.tools import save_opt_trajectories
    from pvr_habitat_tpu_torch.train import bc

    env = "FakePointNav-apartment_0"
    save_opt_trajectories.gen_data_habitat(
        save_opt_trajectories.build_tool_parser().parse_args(
            ["--env", env, "--save_path", str(tmp_path),
             "--n_trajectories", "2", "--max_episode_steps", "30"]))
    save_embedded_obs.run(save_embedded_obs.build_tool_parser().parse_args(
        ["--env", env, "--data_path", str(tmp_path), "--embedding_name",
         "random", "--source", "pickle", "--batch_size", "64",
         "--disable_cuda"]))

    clock = FakeClock()

    class Timer(profiling.StepTimer):
        def __init__(self, **kwargs):
            super().__init__(clock=clock, **kwargs)

        def tick(self):
            clock.now += 1.0
            super().tick()

    evaluate = bc._evaluate

    def slow_evaluate(*args, **kwargs):
        clock.now += 1000.0
        return evaluate(*args, **kwargs)

    monkeypatch.setattr(profiling, "StepTimer", Timer)
    monkeypatch.setattr(bc, "_evaluate", slow_evaluate)
    main_bc_2.run(default_flags(
        env=env, to_env=env, data_path=str(tmp_path),
        save_path=str(tmp_path / "bc"), embedding_name="random",
        batch_size=2, unroll_length=5, max_frames=2 * 5 * 6,
        eval_frequency=2, n_episodes_test=1, max_episode_steps=5,
        disable_cuda=True))
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("   train:")]
    assert lines == ["   train: 1000.00 ms/iter, 10 items/s"] * 3
