"""Standalone embedding server + client on the card (counterpart of
``pvr_habitat_tpu/tools/serve_embeddings.py``).

The simulator (habitat-sim, gym) is host/CPU-side; SURVEY §7 calls for
an env boundary where rollout processes stream observations to an
inference server.  This module is that boundary as a process boundary:
one process owns the card and serves a frozen encoder (an
``EmbeddingNet``); any number of CPU rollout workers connect with
``EmbeddingClient``, which satisfies the EmbeddingNet callable contract
((N, H, W, 3) uint8 -> numpy (N, out_size), squeezed — reference
src/embeddings.py:396-402) and therefore drops straight into
``EmbeddingWrapper``.

Requests arriving within a short window are micro-batched into one
device dispatch — concurrent rollout workers share a forward instead of
issuing batch-1 forwards.  The dispatcher is one thread, the only one
that runs the encoder: the kernels' launch counters and launch-shape
cache see one caller, as on a main thread.  The dispatcher runs one
forward before the server accepts a connection, so the kernels are
built (nvcc, at first use) and the thread's library handles made before
the first request.

Wire protocol (little-endian uint32):
  handshake  server -> client: [out_size]
  request    client -> server: [N, H, W, C] + N*H*W*C uint8
  response   server -> client: [N, D] + N*D float32
  shutdown   client sends N == 0 (closes that connection)

Run:  python -m pvr_habitat_tpu_torch.tools.serve_embeddings \
          --embedding_name resnet50 --port 7045 [--compute_dtype bfloat16]
          [--disable_cuda]
"""

import queue
import socket
import struct
import threading
import time

import numpy as np

_HDR = struct.Struct("<IIII")
JOIN_TIMEOUT_S = 30.0   # close() waits this long for each thread
_RSP = struct.Struct("<II")


def _recv_exact(conn, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = conn.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r
    return bytes(buf)


class EmbeddingServer:
    """Owns an EmbeddingNet and serves it over TCP with micro-batching.

    ``max_batch`` bounds one device dispatch; ``window_ms`` is how long
    the dispatcher waits to coalesce concurrent requests after the
    first one arrives (0 = dispatch immediately, no coalescing).
    """

    def __init__(self, net, host="127.0.0.1", port=0, max_batch=64,
                 window_ms=2.0):
        self.net = net
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.requests_served = 0
        self.batches_served = 0
        self._queue = queue.Queue()
        self._sock = socket.create_server((host, port))
        self.address = self._sock.getsockname()
        self._stop = threading.Event()
        self._threads = []

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        """Start the dispatcher, which first runs one forward on a zero
        64x64 frame (building the kernels of the encoder's route, and
        the per-thread library handles of its own thread), then accept
        connections.  A failed warm-up closes the server and raises."""
        warmed = queue.Queue()

        def dispatch():
            try:
                self.net(np.zeros((1, 64, 64, 3), np.uint8))
            except Exception as exc:  # noqa: BLE001 — raised by start
                warmed.put(exc)
                return
            warmed.put(None)
            self._dispatch_loop()

        self._spawn(dispatch)
        error = warmed.get()
        if error is not None:
            self.close()
            raise error
        self._spawn(self._accept_loop)
        return self

    def _spawn(self, target):
        t = threading.Thread(target=target, daemon=True)
        t.start()
        self._threads.append(t)

    def close(self):
        """Stop accepting, let the dispatcher finish the window it is
        serving, and wait for both threads."""
        self._stop.set()
        try:
            # shutdown wakes the thread blocked in accept(); close alone
            # may not
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._queue.put(None)
        for t in self._threads:
            t.join(JOIN_TIMEOUT_S)

    # -- connection handling ------------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            try:
                conn.sendall(struct.pack("<I", int(self.net.out_size)))
            except (ConnectionError, OSError):
                # Client connected and immediately went away; a failed
                # handshake must not kill the accept loop.
                conn.close()
                continue
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _reader(self, conn):
        try:
            while not self._stop.is_set():
                n, h, w, c = _HDR.unpack(_recv_exact(conn, _HDR.size))
                if n == 0:
                    return
                payload = _recv_exact(conn, n * h * w * c)
                frames = np.frombuffer(payload, np.uint8).reshape(
                    n, h, w, c)
                self._queue.put((frames, conn))
        except (ConnectionError, OSError):
            return
        finally:
            conn.close()

    # -- micro-batching dispatcher ------------------------------------------

    def _dispatch_loop(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            batch = [item]
            total = item[0].shape[0]
            if self.window_s > 0:
                deadline = time.monotonic() + self.window_s
                while total < self.max_batch:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        nxt = self._queue.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._queue.put(None)
                        break
                    batch.append(nxt)
                    total += nxt[0].shape[0]
            # One device dispatch per FRAME SHAPE: requests with
            # different (H, W, C) cannot share a batch.  Compute all
            # groups first, then send in ARRIVAL order — a connection
            # that pipelines two different-shaped requests must get its
            # responses back in request order (the wire protocol has no
            # request ids for the client to re-pair them).
            self._serve_window(batch)

    def _serve_window(self, batch):
        """Compute one micro-batch window (grouped per frame shape) and
        deliver replies in ARRIVAL order.  On a connection with a failed
        request, delivery stops at the failure point: the wire protocol
        has no request ids, so a reply sent past a dropped one would be
        mis-paired by the client.  Earlier successful replies still go
        out (ADVICE r3), THEN the failed connections close (the client
        sees its in-order replies followed by EOF)."""
        groups = {}
        for idx, item in enumerate(batch):
            groups.setdefault(item[0].shape[1:], []).append((idx, item))
        replies, failed = {}, {}
        for group in groups.values():
            group_replies, group_failed = self._compute_batch(group)
            replies.update(group_replies)
            for idx, conn in group_failed:
                failed[conn] = min(idx, failed.get(conn, idx))
        for idx in sorted(replies):
            conn, payload = replies[idx]
            if conn in failed and idx > failed[conn]:
                continue
            try:
                conn.sendall(payload)
            except (ConnectionError, OSError):
                conn.close()
        for conn in failed:
            conn.close()

    def _compute_batch(self, batch):
        """batch: [(idx, (frames, conn))] sharing one frame shape ->
        ({idx: (conn, response bytes)}, [(idx, conn)] for failures).
        A failed forward fails every request in the group; the caller
        decides delivery/close ordering across groups."""
        frames = np.concatenate([b[0] for _, b in batch], axis=0)
        try:
            out = np.asarray(self.net(frames), np.float32).reshape(
                frames.shape[0], -1)
        except Exception:  # noqa: BLE001 — one bad batch must not
            # kill the dispatcher; report the offending requests so the
            # dispatcher can close them after delivering earlier
            # successful replies.
            return {}, [(idx, conn) for idx, (_, conn) in batch]
        self.requests_served += len(batch)
        self.batches_served += 1
        replies = {}
        row = 0
        for idx, (req_frames, conn) in batch:
            n = req_frames.shape[0]
            part = np.ascontiguousarray(out[row:row + n])
            row += n
            replies[idx] = (conn, _RSP.pack(n, part.shape[1])
                            + part.tobytes())
        return replies, []


class EmbeddingClient:
    """Callable (N, H, W, 3) uint8 -> numpy (N, out_size) squeezed —
    the EmbeddingNet serving contract, over a socket.  Drop-in for
    EmbeddingWrapper on hosts without a card."""

    def __init__(self, address, timeout=60.0, first_timeout=300.0):
        # The first request may land on a server still building its
        # kernels (``EmbeddingServer.start``), so it gets its own
        # generous deadline; steady-state requests use ``timeout``.
        self._conn = socket.create_connection(address,
                                              timeout=first_timeout)
        self._timeout = timeout
        self._warmed = False
        self.out_size = struct.unpack(
            "<I", _recv_exact(self._conn, 4))[0]
        self._lock = threading.Lock()

    def __call__(self, observation):
        frames = np.ascontiguousarray(np.asarray(observation, np.uint8))
        n, h, w, c = frames.shape
        with self._lock:
            self._conn.sendall(_HDR.pack(n, h, w, c) + frames.tobytes())
            rn, rd = _RSP.unpack(_recv_exact(self._conn, _RSP.size))
            payload = _recv_exact(self._conn, rn * rd * 4)
            if not self._warmed:
                self._warmed = True
                self._conn.settimeout(self._timeout)
        out = np.frombuffer(payload, np.float32).reshape(rn, rd)
        return out.squeeze()

    def close(self):
        try:
            self._conn.sendall(_HDR.pack(0, 0, 0, 0))
        except OSError:
            pass
        self._conn.close()


def main():
    from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
    from pvr_habitat_tpu_torch.train.bc import compute_dtype, flags_device
    from pvr_habitat_tpu_torch.utils.flags import build_parser

    parser = build_parser()
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7045)
    parser.add_argument("--max_batch", type=int, default=64)
    parser.add_argument("--window_ms", type=float, default=2.0)
    flags = parser.parse_args()

    net = EmbeddingNet(
        flags.embedding_name, in_channels=3,
        pretrained=flags.pretrained_embedding,
        checkpoint_dir=flags.data_path, run_id=flags.run_id,
        compute_dtype=compute_dtype(flags), device=flags_device(flags))
    server = EmbeddingServer(net, host=flags.host, port=flags.port,
                             max_batch=flags.max_batch,
                             window_ms=flags.window_ms).start()
    print(f"serving {flags.embedding_name} (out_size {net.out_size}, "
          f"{flags.compute_dtype}, route {net.fused}, {net.device}) "
          f"on {server.address[0]}:{server.address[1]}", flush=True)
    threading.Event().wait()  # serve forever


if __name__ == "__main__":
    main()
