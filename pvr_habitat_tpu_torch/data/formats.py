"""On-disk trajectory/dataset formats — the drop-in public contract
(counterpart of ``pvr_habitat_tpu/data/formats.py``; its pickle parts,
copied):

- Raw trajectory pickle '{data_path}/{env}.pickle': dict(obs, action,
  reward, done, true_state), each a LIST of per-trajectory arrays; obs
  (T,64,64,3) uint8 PointNav or (T,64,64,6) ImageNav; actions STOP-free
  0-based ints (save_opt_trajectories.py:25-31,100-106).
- Embedded pickle '{data_path}/{env}_{embedding}.pickle': flat arrays
  obs (N, O*n_frames) float, action/reward/done (N,), true_state (N,12)
  (save_embedded_obs.py:159-172).
- PNG layout '{data_path}/{env}/': per-traj '{t}.pickle'
  (action/reward/done/true_state) + '{t}_{s}.png' + '{t}_goal.png'.
- JPEG layout: '{t}.pickle' = pose-only true_state + '{t}_{s}.jpeg'.

PNG files are written by ``cv2.imwrite`` (the array's channels reversed
in the file) and read back through ``data/native.py`` with ``bgr=True``,
so the channel order round-trips.  JPEG files are written by PIL with no
swap, as in the JAX package.
"""

import os
import pickle
import queue
import threading

import numpy as np

from pvr_habitat_tpu_torch.data import native


def save_raw_trajectories(path, data):
    with open(path, "wb") as handle:
        pickle.dump(data, handle, protocol=pickle.HIGHEST_PROTOCOL)


def load_pickle(path):
    with open(path, "rb") as handle:
        return pickle.load(handle)


def read_habitat_data(data_path, n_trajectories=-1, verbose=True):
    """Load + merge per-trajectory lists (reference: src/utils_bc.py:33-49)."""
    if verbose:
        print(f"loading {data_path} ...")
    data = load_pickle(data_path)
    if n_trajectories == -1:
        n_trajectories = len(data["reward"])
    out = {}
    for key in ("obs", "action", "reward", "done", "true_state"):
        out[key] = np.concatenate(data[key][:n_trajectories])
    n_samples = len(out["reward"])
    if verbose:
        print(f"   {n_trajectories} trajectories for a total of "
              f"{n_samples} samples")
        print("   avg. return is", out["reward"].sum() / n_trajectories)
    return out


def save_embedded(path, obs, action, reward, done, true_state):
    data = dict(obs=np.asarray(obs), action=np.asarray(action),
                reward=np.asarray(reward), done=np.asarray(done),
                true_state=np.asarray(true_state))
    with open(path, "wb") as handle:
        pickle.dump(data, handle, protocol=pickle.HIGHEST_PROTOCOL)


def embedded_path(data_path, env, embedding_name):
    return os.path.join(data_path, f"{env}_{embedding_name}.pickle")


def raw_path(data_path, env):
    return os.path.join(data_path, f"{env}.pickle")


# -- PNG / JPEG per-frame layouts --------------------------------------------


def save_png_trajectory(dir_path, traj_idx, obs_list, action, reward, done,
                        true_state):
    try:
        import cv2
    except ImportError as exc:
        raise RuntimeError("the PNG layout is written by cv2.imwrite "
                           "(opencv-python), which is not installed") from exc

    os.makedirs(dir_path, exist_ok=True)
    for i, obs in enumerate(obs_list):
        cv2.imwrite(os.path.join(dir_path, f"{traj_idx}_{i}.png"),
                    obs[:, :, :3])
    if obs_list and obs_list[-1].shape[-1] > 3:  # ImageNav goal frame
        cv2.imwrite(os.path.join(dir_path, f"{traj_idx}_goal.png"),
                    obs_list[-1][:, :, 3:])
    data = dict(action=action, reward=reward, done=done,
                true_state=true_state)
    with open(os.path.join(dir_path, f"{traj_idx}.pickle"), "wb") as handle:
        pickle.dump(data, handle, protocol=pickle.HIGHEST_PROTOCOL)


def save_jpeg_trajectory(dir_path, traj_idx, obs_list, true_state,
                         frameskip=3):
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError("the JPEG layout is written by PIL (Pillow), "
                           "which is not installed") from exc

    os.makedirs(dir_path, exist_ok=True)
    pose = np.asarray(true_state)[:, :8]  # agent position + orientation
    with open(os.path.join(dir_path, f"{traj_idx}.pickle"), "wb") as handle:
        pickle.dump(pose, handle, protocol=pickle.HIGHEST_PROTOCOL)
    for i in range(0, len(obs_list), frameskip):
        Image.fromarray(obs_list[i][:, :, :3]).save(
            os.path.join(dir_path, f"{traj_idx}_{i}.jpeg"))


def _iter_png_trajectories(dir_path, n_trajectories, max_steps, hw):
    """Yields (meta, frames, goal_frame|None) per trajectory, decoding
    each frame batch with the native multithreaded codec."""
    h, w = hw
    for t in range(n_trajectories):
        meta_path = os.path.join(dir_path, f"{t}.pickle")
        if not os.path.isfile(meta_path):
            return
        meta = load_pickle(meta_path)
        n_frames = native.count_frames(dir_path, t, "png", max_steps)
        paths = [os.path.join(dir_path, f"{t}_{s}.png")
                 for s in range(n_frames)]
        frames = native.decode_batch(paths, h, w, kind="png", bgr=True)
        goal_path = os.path.join(dir_path, f"{t}_goal.png")
        goal = None
        if os.path.isfile(goal_path):
            goal = native.decode_batch([goal_path], h, w, "png", True)[0]
        yield meta, frames, goal


def _prefetched(iterator, depth=2):
    """Run `iterator` on a producer thread with a bounded queue so the
    NEXT trajectory's decode overlaps the CURRENT one's device embed
    (the native codec releases the GIL inside libpng/libjpeg)."""
    q = queue.Queue(maxsize=depth)
    end = object()

    def produce():
        try:
            for item in iterator:
                q.put(item)
            q.put(end)
        except BaseException as exc:  # surface decode errors downstream
            q.put(exc)

    threading.Thread(target=produce, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def read_png_trajectories(dir_path, embed_fn=None, n_trajectories=-1,
                          max_steps=500, hw=(64, 64), prefetch=2):
    """PNG-dir reader (reference: save_embedded_obs.py:50-93): per-frame
    obs (optionally embedded) with the goal frame appended.  Frames are
    decoded in batch by the native multithreaded codec (see
    ``data/native.py`` for its fallbacks), keeping cv2.imread's BGR
    channel convention for file round-trip parity with the reference.
    ``prefetch`` trajectories are decoded ahead on a producer thread,
    pipelining host decode with device embedding (0 = synchronous)."""
    data = dict(obs=[], action=[], reward=[], done=[], true_state=[])
    if n_trajectories == -1:
        n_trajectories = 100000
    stream = _iter_png_trajectories(dir_path, n_trajectories, max_steps, hw)
    if prefetch:
        stream = _prefetched(stream, depth=prefetch)
    for meta, frames, goal in stream:
        for key in ("action", "reward", "done", "true_state"):
            data[key].append(meta[key])
        n_frames = frames.shape[0]
        if goal is not None and embed_fn is not None:
            goal = np.asarray(embed_fn(goal[None])).reshape(-1)
        if embed_fn is not None:
            obs = np.asarray(embed_fn(frames)).reshape(n_frames, -1)
        else:
            obs = frames
        if goal is not None:
            goal_rep = np.broadcast_to(goal, (n_frames,) + goal.shape)
            obs = np.concatenate((obs, goal_rep), axis=-1)
        data["obs"].extend(obs)
    out = dict(obs=np.stack(data["obs"]))
    for key in ("action", "reward", "done", "true_state"):
        out[key] = np.concatenate(data[key])
    return out
