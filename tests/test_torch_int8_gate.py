"""The int8 BC-loss gate on the port (the second half of the JAX
package's ``tests/test_quantize.py::test_int8_bench_gate_on_fakenav_data``,
at its sizes, on the CPU): on 64 FakePointNav-hotel_0 frames, the port's
``ShardedEmbedder(quantize=True)`` embeddings stay within cosine 0.99 of
the f32 ones, and a BC policy trained on them (the port's train step, 60
steps at T 16, B 4) reaches a teacher-forced loss within 10% of one
trained on the f32 embeddings, with the same data and seeds."""

import numpy as np
import torch
from threadpoolctl import threadpool_limits

from pvr_habitat_tpu_torch.data.embed_pipeline import ShardedEmbedder
from pvr_habitat_tpu_torch.envs.environment import make_environment
from pvr_habitat_tpu_torch.train import bc_step
from pvr_habitat_tpu_torch.utils.flags import default_flags


def _fakenav_frames():
    """64 frames of a FakeNav scene under random actions."""
    flags = default_flags(env="FakePointNav-hotel_0",
                          embedding_name="resnet50", max_episode_steps=16)
    env = make_environment(flags, None)
    rng = np.random.RandomState(0)
    frames, actions, dones = [], [], []
    out = env.initial()
    for _ in range(64):
        frames.append(np.asarray(out["obs"])[0, 0])
        a = rng.randint(0, 3)
        actions.append(a)
        out = env.step(np.array([[a]]))
        dones.append(bool(out["done"][0, 0]))
    env.close()
    return np.stack(frames), actions, dones


def _train_loss(embeds, actions, dones):
    t, b = 16, 4
    batch = dict(
        obs=torch.from_numpy(embeds.reshape(t, b, -1).astype(np.float32)),
        action=torch.as_tensor(np.asarray(actions, np.int64).reshape(t, b)),
        done=torch.as_tensor(np.asarray(dones, bool).reshape(t, b)))
    flags = default_flags(learning_rate=1e-3)
    state, opt = bc_step.create_train_state(
        np.random.RandomState(1), (embeds.shape[1],), 3, flags,
        max_epochs=60, device="cpu")
    step = bc_step.make_train_step(opt)
    for _ in range(60):
        state, metrics = step(state, batch)
    return float(metrics["loss"])


def test_int8_bc_loss_gate_on_fakenav_data():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(2):
            frames, actions, dones = _fakenav_frames()
            assert frames.shape == (64, 64, 64, 3)
            emb_q = ShardedEmbedder("resnet50", device="cpu", batch_size=16,
                                    pretrained=False, quantize=True)
            emb_f = ShardedEmbedder("resnet50", device="cpu", batch_size=16,
                                    pretrained=False,
                                    compute_dtype=torch.float32)
            got, want = emb_q.embed_all(frames), emb_f.embed_all(frames)
            cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                          * np.linalg.norm(want, axis=-1))
            assert cos.min() > 0.99, cos.min()
            loss_q = _train_loss(got, actions, dones)
            loss_f = _train_loss(want, actions, dones)
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite([loss_q, loss_f]).all()
    assert abs(loss_q - loss_f) <= 0.1 * max(loss_f, 1e-3), (loss_q, loss_f)
