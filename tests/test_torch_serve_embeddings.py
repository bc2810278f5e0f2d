"""The port's embedding server and client (``tools/serve_embeddings.py``)
against the JAX package's ``EmbeddingNet`` on the same seeded frames
(CPU): the JAX server's cases (one client, the batch-1 squeeze,
concurrent micro-batching, the env wrapper, pipelined mixed shapes kept
in request order, a shape mismatch, a failed group), with the ``random``
encoder at 1e-4 (the JAX test's tolerance) and ``resnet50`` f32 at 64x64
at 1e-3 (BASELINE.md); then the CLI's ``main``."""

import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pvr_habitat_tpu.models.embedding_net import EmbeddingNet as JaxNet
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.tools import serve_embeddings
from pvr_habitat_tpu_torch.tools.serve_embeddings import (_HDR, _RSP,
                                                          EmbeddingClient,
                                                          EmbeddingServer)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


class CountingNet:
    """An ``EmbeddingNet`` that records the batch size of each call and
    the thread that made it."""

    def __init__(self, net):
        self.net, self.out_size = net, net.out_size
        self.sizes, self.threads = [], set()

    def __call__(self, frames):
        self.sizes.append(frames.shape[0])
        self.threads.add(threading.get_ident())
        return self.net(frames)


@pytest.fixture(scope="module")
def jax_net():
    return JaxNet("random", pretrained=False)


@pytest.fixture(scope="module")
def server():
    net = CountingNet(EmbeddingNet("random", pretrained=False, device="cpu"))
    srv = EmbeddingServer(net, port=0, max_batch=64, window_ms=5.0)
    srv.start()
    yield srv
    srv.close()
    assert not any(t.is_alive() for t in srv._threads)


def _frames(seed, n, hw=64):
    return np.random.RandomState(seed).randint(
        0, 256, size=(n, hw, hw, 3), dtype=np.uint8)


def test_client_matches_direct_embedding(server, jax_net):
    client = EmbeddingClient(server.address)
    assert client.out_size == jax_net.out_size
    frames = _frames(0, 5)
    got = client(frames)
    want = jax_net(frames)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    client.close()


def test_batch_one_squeeze_contract(server):
    client = EmbeddingClient(server.address)
    out = client(_frames(1, 1))
    assert out.shape == (client.out_size,)
    client.close()


def test_concurrent_clients_microbatch(server, jax_net):
    """Concurrent rollout workers get their own rows back; every forward,
    the warm-up of ``start`` included, runs on the dispatcher thread."""
    results = {}

    def worker(seed):
        client = EmbeddingClient(server.address)
        rng = np.random.RandomState(seed)
        outs = []
        for _ in range(3):
            frames = rng.randint(0, 256, size=(4, 64, 64, 3),
                                 dtype=np.uint8)
            outs.append((frames, client(frames)))
        client.close()
        results[seed] = outs

    threads = [threading.Thread(target=worker, args=(s,))
               for s in (10, 11, 12)]
    before = server.requests_served
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(results) == 3
    frames = np.concatenate([f for outs in results.values()
                             for f, _ in outs])
    got = np.concatenate([g for outs in results.values() for _, g in outs])
    np.testing.assert_allclose(got, jax_net(frames), atol=TOL, rtol=TOL)
    assert server.requests_served - before == 9
    assert server.net.sizes[0] == 1                    # the warm-up
    assert server.net.threads == {server._threads[0].ident}


def test_many_clients_stress(server):
    """More clients than cores, with the interpreter switching threads
    often: every reply is its own request's rows (a mixed-up window
    would pair rows with the wrong request) and every request is
    counted once."""
    direct = server.net.net
    n_clients, n_requests = 16, 5
    results, errors = {}, []

    def worker(seed):
        try:
            rng = np.random.RandomState(seed)
            client = EmbeddingClient(server.address)
            outs = []
            for _ in range(n_requests):
                frames = rng.randint(0, 256, size=(rng.randint(1, 4), 64, 64,
                                                   3), dtype=np.uint8)
                outs.append((frames, client(frames)))
            client.close()
            results[seed] = outs
        except Exception as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    before = server.requests_served
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(100 + c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors and len(results) == n_clients
    for outs in results.values():
        for frames, got in outs:
            np.testing.assert_allclose(got, direct(frames), atol=1e-5,
                                       rtol=1e-5)
    assert server.requests_served - before == n_clients * n_requests


def test_wrapper_integration(server):
    """EmbeddingClient drops into the port's EmbeddingWrapper in place of
    a local EmbeddingNet."""
    from pvr_habitat_tpu_torch.envs.fake_nav import FakeNavSim
    from pvr_habitat_tpu_torch.envs.wrappers import (EmbeddingWrapper,
                                                     NavigationWrapper)

    sim = FakeNavSim("hotel_0", seed=3)
    env = NavigationWrapper(sim, "hotel_0", seed=3)
    client = EmbeddingClient(server.address)
    wrapped = EmbeddingWrapper(env, client)
    obs = wrapped.reset()
    assert obs.shape == (client.out_size,)
    obs, _, _, _ = wrapped.step(0)
    assert obs.shape == (client.out_size,)
    client.close()


def _recv(conn, n):
    buf = b""
    while len(buf) < n:
        r = conn.recv(n - len(buf))
        assert r, "server closed mid-response"
        buf += r
    return buf


def test_pipelined_mixed_shapes_keep_request_order(server, jax_net):
    """Requests of different frame shapes pipelined on one connection come
    back in request order (the wire protocol has no request ids)."""
    rng = np.random.RandomState(30)
    reqs = [rng.randint(0, 256, size=(2, hw, hw, 3), dtype=np.uint8)
            for hw in (32, 64, 32)]
    conn = socket.create_connection(server.address, timeout=60)
    try:
        struct.unpack("<I", _recv(conn, 4))
        for frames in reqs:
            conn.sendall(_HDR.pack(*frames.shape) + frames.tobytes())
        for frames in reqs:
            n, d = _RSP.unpack(_recv(conn, _RSP.size))
            assert n == frames.shape[0]
            out = np.frombuffer(_recv(conn, 4 * n * d),
                                np.float32).reshape(n, d)
            np.testing.assert_allclose(out, jax_net(frames), atol=TOL,
                                       rtol=TOL)
        conn.sendall(_HDR.pack(0, 0, 0, 0))
    finally:
        conn.close()


def test_shape_mismatch_does_not_kill_dispatcher(server, jax_net):
    results = {}

    def worker(seed, hw):
        client = EmbeddingClient(server.address)
        frames = _frames(seed, 2, hw)
        results[seed] = (frames, client(frames))
        client.close()

    threads = [threading.Thread(target=worker, args=(20, 64)),
               threading.Thread(target=worker, args=(21, 32))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert set(results) == {20, 21}
    for frames, got in results.values():
        np.testing.assert_allclose(got, jax_net(frames), atol=TOL, rtol=TOL)
    client = EmbeddingClient(server.address)
    frames = _frames(22, 3)
    np.testing.assert_allclose(client(frames), jax_net(frames), atol=TOL,
                               rtol=TOL)
    client.close()


def test_failed_group_still_delivers_earlier_replies():
    """A failed shape group fails its requests: a connection that
    pipelined across groups gets its replies up to the failure, in
    order, then EOF; nothing is answered by another path."""

    class FlakyNet:
        out_size = 8

        def __call__(self, frames):
            if frames.shape[1] == 48:
                raise ValueError("boom")
            return np.zeros((frames.shape[0], 8), np.float32)

    class FakeConn:
        def __init__(self):
            self.sent = []
            self.closed = False

        def sendall(self, payload):
            if self.closed:
                raise ConnectionError("closed")
            self.sent.append(payload)

        def close(self):
            self.closed = True

    srv = EmbeddingServer.__new__(EmbeddingServer)
    srv.net = FlakyNet()
    srv.requests_served = 0
    srv.batches_served = 0
    good = np.zeros((2, 32, 32, 3), np.uint8)
    bad = np.zeros((2, 48, 48, 3), np.uint8)
    conn, other = FakeConn(), FakeConn()
    srv._serve_window([(good, conn), (bad, conn), (good, conn),
                       (good, other)])
    assert len(conn.sent) == 1
    assert _RSP.unpack(conn.sent[0][:_RSP.size]) == (2, 8)
    assert conn.closed
    assert len(other.sent) == 1 and not other.closed
    assert (srv.requests_served, srv.batches_served) == (3, 1)


def test_failed_warmup_raises_from_start():
    class BrokenNet:
        out_size = 8

        def __call__(self, frames):
            raise RuntimeError("no kernel")

    srv = EmbeddingServer(BrokenNet(), port=0)
    with pytest.raises(RuntimeError, match="no kernel"):
        srv.start()
    assert not any(t.is_alive() for t in srv._threads)
    with pytest.raises(OSError):
        socket.create_connection(srv.address, timeout=5)


def test_resnet50_f32_matches_jax():
    """ResNet-50 f32 at 64x64 through the server, two clients at once,
    against the JAX EmbeddingNet at 1e-3."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    net = CountingNet(EmbeddingNet("resnet50", pretrained=False,
                                   device="cpu"))
    srv = EmbeddingServer(net, port=0, max_batch=64, window_ms=50.0).start()
    try:
        frames = _frames(40, 5)
        results = {}

        def worker(part):
            client = EmbeddingClient(srv.address)
            results[part.start] = client(frames[part])
            client.close()

        threads_ = [threading.Thread(target=worker, args=(p,))
                    for p in (slice(0, 2), slice(2, 5))]
        for t in threads_:
            t.start()
        for t in threads_:
            t.join(timeout=300)
            assert not t.is_alive()
    finally:
        srv.close()
        torch.set_num_threads(threads)
    got = np.concatenate([results[0], results[2]])
    want = JaxNet("resnet50", pretrained=False)(frames)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    assert sum(net.sizes[1:]) == 5


def test_main_serves_with_disable_cuda_and_needs_cuda_otherwise(
        monkeypatch):
    """The CLI: with --disable_cuda it serves on the CPU (a subprocess,
    killed after one request; the ``random`` encoder of its default
    run_id, 1); without it and without CUDA it raises before it
    listens."""
    jax_net = JaxNet("random", pretrained=False, run_id=1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "pvr_habitat_tpu_torch.tools.serve_embeddings",
         "--embedding_name", "random", "--port", str(port),
         "--disable_pretrained_embedding", "--disable_cuda"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + 120
        client = None
        while client is None:
            try:
                client = EmbeddingClient(("127.0.0.1", port))
            except ConnectionRefusedError:
                assert proc.poll() is None, proc.stdout.read()
                assert time.monotonic() < deadline, "server never listened"
                time.sleep(0.2)
        frames = _frames(50, 2)
        np.testing.assert_allclose(client(frames), jax_net(frames),
                                   atol=TOL, rtol=TOL)
        client.close()
    finally:
        proc.kill()
        out = proc.communicate(timeout=60)[0]
    assert "serving random" in out and "cpu" in out, out
    if not torch.cuda.is_available():
        monkeypatch.setattr(sys, "argv", [
            "serve_embeddings", "--embedding_name", "random", "--port",
            str(port), "--disable_pretrained_embedding"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_embeddings.main()
