"""FakeNav — a hermetic, in-process navigation simulator (a copy of
``pvr_habitat_tpu/envs/fake_nav.py``; pure numpy, so both packages render
the same frames and draw the same goals for the same seeds).

Stands in for habitat-sim so data generation, online evaluation and the
full BC loop run without external assets (SURVEY.md §4 test strategy).
It implements the simulator surface the reference wrapper consumes:
discrete fwd/turn actions, RGB egocentric rendering, navigable-point
sampling, geodesic distances, rendering at arbitrary poses, and a
greedy shortest-path follower (habitat's ``get_action_shortest_path``
equivalent).

World model: per-scene procedural floor plan (recursive-division maze
with door gaps — connected by construction) on a 0.25 m occupancy grid;
observations come from a vectorized column raycaster (numpy, host-side
— the simulator is a CPU boundary in the real system too).  The goal is
rendered as a bright beacon so RGB-only policies can actually learn the
task.  Geometry mirrors habitat_config/nav_task.yaml: 64x64 RGB,
HFOV 79, forward 0.25 m, turn 10 deg, success distance 0.2, max 500
steps, SUCCESS_REWARD 2.5 with NavRLEnv-style shaping
(slack - delta geodesic).
"""

import hashlib

import numpy as np

from pvr_habitat_tpu_torch.utils.profiling import span

CELL = 0.25
GRID = 40                      # 10 m x 10 m world
HFOV_DEG = 79.0
IMG_HW = 64
FORWARD_STEP = 0.25
TURN_ANGLE_DEG = 10.0
MAX_EPISODE_STEPS = 500
SUCCESS_DISTANCE = 0.2
SUCCESS_REWARD = 2.5
SLACK_REWARD = -0.01
CAMERA_HEIGHT = 0.88

_RAY_STEP = 0.05
_RAY_N = 280                   # 14 m range


def _scene_seed(scene):
    return int.from_bytes(
        hashlib.sha256(scene.encode()).digest()[:4], "little")


def _free_connected(occ):
    """True iff every free cell is 4-neighbor reachable from any other."""
    free = ~occ
    n_free = int(free.sum())
    if n_free == 0:
        return False
    start = tuple(np.argwhere(free)[0])
    seen = np.zeros_like(free)
    seen[start] = True
    frontier = [start]
    reached = 1
    while frontier:
        nxt = []
        for x, z in frontier:
            for dx, dz in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                nx, nz = x + dx, z + dz
                if 0 <= nx < GRID and 0 <= nz < GRID and free[nx, nz] \
                        and not seen[nx, nz]:
                    seen[nx, nz] = True
                    reached += 1
                    nxt.append((nx, nz))
        frontier = nxt
    return reached == n_free


def _make_floor_plan(scene):
    """Occupancy grid + per-cell wall colors, deterministic per scene.

    Scene variety (round-2): maze depth 2-4, every wall segment gets
    its own hue family (rooms become visually distinguishable
    landmarks — relevant for ImageNav), and 3-9 free-standing pillar
    obstacles in bright accent colors, each accepted only if the free
    space stays connected.
    """
    rng = np.random.RandomState(_scene_seed(scene))
    occ = np.zeros((GRID, GRID), bool)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True

    base = rng.randint(60, 200, size=3)
    jitter = rng.randint(0, 80, size=(GRID, GRID, 3))
    colors = np.clip(base[None, None, :] + jitter, 40, 255).astype(np.int32)

    def wall_hue():
        return np.clip(base + rng.randint(-70, 71, size=3), 40, 230)

    # distinct hue per boundary wall (orientation landmarks)
    for sl in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
        colors[sl] = np.clip(wall_hue()[None, :]
                             + rng.randint(0, 50, size=(GRID, 1)), 40, 255)

    def paint(sl):
        hue = wall_hue()
        cells = colors[sl]
        colors[sl] = np.clip(
            hue[None, :] + rng.randint(0, 50, size=(cells.shape[0], 1)),
            40, 255)

    def divide(x0, x1, z0, z1, depth):
        if depth <= 0 or (x1 - x0) < 6 or (z1 - z0) < 6:
            return
        if (x1 - x0) >= (z1 - z0):
            split = rng.randint(x0 + 3, x1 - 2)
            door = rng.randint(z0 + 1, z1)
            occ[split, z0:z1 + 1] = True
            occ[split, door] = False
            occ[split, min(door + 1, z1)] = False
            paint(np.s_[split, z0:z1 + 1])
            divide(x0, split - 1, z0, z1, depth - 1)
            divide(split + 1, x1, z0, z1, depth - 1)
        else:
            split = rng.randint(z0 + 3, z1 - 2)
            door = rng.randint(x0 + 1, x1)
            occ[x0:x1 + 1, split] = True
            occ[door, split] = False
            occ[min(door + 1, x1), split] = False
            paint(np.s_[x0:x1 + 1, split])
            divide(x0, x1, z0, split - 1, depth - 1)
            divide(x0, x1, split + 1, z1, depth - 1)

    divide(1, GRID - 2, 1, GRID - 2, depth=2 + rng.randint(0, 2))

    # free-standing pillars: bright landmarks, connectivity-preserving
    for _ in range(rng.randint(3, 10)):
        x, z = rng.randint(2, GRID - 2, size=2)
        if occ[x, z]:
            continue
        occ[x, z] = True
        if _free_connected(occ):
            accent = rng.randint(120, 256, size=3)
            accent[rng.randint(3)] = rng.randint(0, 60)  # saturated
            colors[x, z] = accent
        else:
            occ[x, z] = False

    colors = colors.astype(np.uint8)
    floor = np.clip(base * 0.5 + rng.randint(-15, 16, size=3),
                    20, 255).astype(np.uint8)
    sky = np.clip(base * 0.3 + 120 + rng.randint(-25, 26, size=3),
                  0, 255).astype(np.uint8)
    return occ, colors, floor, sky


def _bfs_field(occ, goal_cell):
    """Geodesic distance (meters) to goal over 4-neighbor free cells."""
    dist = np.full(occ.shape, np.inf, np.float32)
    gx, gz = goal_cell
    if occ[gx, gz]:
        return dist
    dist[gx, gz] = 0.0
    frontier = [(gx, gz)]
    while frontier:
        nxt = []
        for x, z in frontier:
            d = dist[x, z] + CELL
            for dx, dz in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                nx, nz = x + dx, z + dz
                if 0 <= nx < GRID and 0 <= nz < GRID and not occ[nx, nz] \
                        and d < dist[nx, nz]:
                    dist[nx, nz] = d
                    nxt.append((nx, nz))
        frontier = nxt
    return dist


def quat_from_heading(theta):
    """y-axis rotation as (w, x, y, z) — quaternion.as_float_array order."""
    return np.array([np.cos(theta / 2), 0.0, np.sin(theta / 2), 0.0],
                    np.float32)


class FakeNavSim:
    """The simulator proper (habitat-sim stand-in)."""

    max_episode_steps = MAX_EPISODE_STEPS
    success_distance = SUCCESS_DISTANCE
    success_reward = SUCCESS_REWARD
    action_count = 4  # STOP, FORWARD, LEFT, RIGHT (habitat v0 space)

    def __init__(self, scene, seed=0, max_episode_steps=MAX_EPISODE_STEPS):
        self.scene = scene
        self.max_episode_steps = int(max_episode_steps)
        self.occ, self.wall_colors, self.floor_color, self.sky_color = \
            _make_floor_plan(scene)
        self.rng = np.random.RandomState(seed + _scene_seed(scene) % 10007)
        self.pos = self.sample_navigable_point()
        self.heading = 0.0
        # The PointNav goal is a SCENE property, not an env-instance
        # property: the reference pins it to the scene dataset's
        # episodes[0].goals[0] (src/gym_wrappers.py:210,251,265 reads
        # it; behavioral_cloning/save_opt_trajectories.py:45 generates
        # expert data toward it), so datagen, training, and every eval
        # env — whatever its seed — navigate to the SAME goal, and
        # randomize() redraws only the start.  Round 5 found the
        # original env-seed-drawn goal silently broke that contract:
        # each eval env got its own goal, so BC was scored on goals it
        # was never trained toward (docs/DESIGN.md "eval-protocol
        # dissection").  ImageNav still redraws goals per episode via
        # randomize_goal(), as in the reference.
        goal_rng = np.random.RandomState((_scene_seed(scene) + 9173)
                                         % (2 ** 31))
        self.goal_position = self._sample_navigable_point_from(goal_rng)
        self._field = _bfs_field(self.occ, self._cell(self.goal_position))
        self._steps = 0
        self._episode_over = False
        self.start_position = self.pos.copy()
        self.start_rotation = quat_from_heading(self.heading)

    # -- geometry -------------------------------------------------------

    def _cell(self, pos):
        return (int(np.clip(pos[0] / CELL, 0, GRID - 1)),
                int(np.clip(pos[2] / CELL, 0, GRID - 1)))

    def is_navigable(self, pos):
        x, z = self._cell(pos)
        return not self.occ[x, z]

    def sample_navigable_point(self):
        return self._sample_navigable_point_from(self.rng)

    def _sample_navigable_point_from(self, rng):
        while True:
            x = rng.uniform(CELL, (GRID - 1) * CELL)
            z = rng.uniform(CELL, (GRID - 1) * CELL)
            pos = np.array([x, 0.0, z], np.float32)
            if self.is_navigable(pos):
                return pos

    def geodesic_distance(self, pos, goal=None):
        if goal is None or np.allclose(goal, self.goal_position):
            field = self._field
        else:
            field = _bfs_field(self.occ, self._cell(goal))
        return float(field[self._cell(pos)])

    # -- episode control --------------------------------------------------

    def set_episode(self, start_position, start_rotation_heading,
                    goal_position):
        self.start_position = np.asarray(start_position, np.float32)
        self._start_heading = float(start_rotation_heading)
        self.start_rotation = quat_from_heading(self._start_heading)
        self.goal_position = np.asarray(goal_position, np.float32)
        self._field = _bfs_field(self.occ, self._cell(self.goal_position))

    def reset(self):
        self.pos = self.start_position.copy()
        self.heading = getattr(self, "_start_heading", 0.0)
        self._steps = 0
        self._episode_over = False
        self._prev_geo = self.geodesic_distance(self.pos)
        return {"rgb": self.render_at(self.pos, self.heading)}

    def get_agent_state(self):
        position = np.array([self.pos[0], CAMERA_HEIGHT, self.pos[2]],
                            np.float32)
        return position, quat_from_heading(self.heading)

    def _success(self):
        return self.geodesic_distance(self.pos) <= SUCCESS_DISTANCE

    def step(self, action):
        """habitat v0 action ids: 0 STOP, 1 FORWARD, 2 LEFT, 3 RIGHT.
        NavRLEnv-style shaped reward (slack + geodesic improvement,
        success bonus), done on success/STOP/max steps."""
        assert not self._episode_over, "step() after episode end"
        if action == 1:
            delta = FORWARD_STEP * np.array(
                [np.cos(self.heading), 0.0, np.sin(self.heading)], np.float32)
            cand = self.pos + delta
            if self.is_navigable(cand):
                self.pos = cand
        elif action == 2:
            self.heading += np.deg2rad(TURN_ANGLE_DEG)
        elif action == 3:
            self.heading -= np.deg2rad(TURN_ANGLE_DEG)

        self._steps += 1
        geo = self.geodesic_distance(self.pos)
        reward = SLACK_REWARD + (self._prev_geo - geo)
        self._prev_geo = geo
        success = self._success()
        if success:
            reward += SUCCESS_REWARD
        done = success or action == 0 or self._steps >= self.max_episode_steps
        self._episode_over = done
        obs = {"rgb": self.render_at(self.pos, self.heading)}
        info = {"success": float(success)}
        return obs, float(reward), bool(done), info

    # -- rendering ---------------------------------------------------------

    def get_observations_at(self, position, rotation=None, heading=None):
        if heading is None:
            # rotation = [x, y, z, w] list as built by the reference
            # (gym_wrappers.py:253-258): y-axis rotation components.
            heading = 2.0 * np.arctan2(rotation[1], rotation[3])
        return {"rgb": self.render_at(np.asarray(position, np.float32),
                                      float(heading))}

    def render_at(self, pos, heading):
        """The (IMG_HW, IMG_HW, 3) uint8 view from ``pos`` at ``heading``,
        inside an ``env.render`` span (``utils/profiling.py``)."""
        with span("env.render"):
            return self._render(pos, heading)

    def _render(self, pos, heading):
        h = IMG_HW
        half_fov = np.deg2rad(HFOV_DEG) / 2.0
        col_angles = heading + np.linspace(half_fov, -half_fov, h)

        radii = (np.arange(1, _RAY_N + 1) * _RAY_STEP)[None, :]   # (1, R)
        dx = np.cos(col_angles)[:, None] * radii                   # (C, R)
        dz = np.sin(col_angles)[:, None] * radii
        px = np.clip(((pos[0] + dx) / CELL).astype(np.int32), 0, GRID - 1)
        pz = np.clip(((pos[2] + dz) / CELL).astype(np.int32), 0, GRID - 1)
        hits = self.occ[px, pz]                                    # (C, R)
        first = np.argmax(hits, axis=1)
        no_hit = ~hits[np.arange(h), first]
        first = np.where(no_hit, _RAY_N - 1, first)
        dist = (first + 1) * _RAY_STEP
        # fisheye correction
        dist_c = np.maximum(dist * np.cos(col_angles - heading), 0.12)

        wall_cells_x = px[np.arange(h), first]
        wall_cells_z = pz[np.arange(h), first]
        col_rgb = self.wall_colors[wall_cells_x, wall_cells_z].astype(
            np.float32)
        shade = 1.0 / (1.0 + 0.25 * dist_c)
        # cheap vertical texture from hit-point fraction
        hit_x = pos[0] + np.cos(col_angles) * dist
        hit_z = pos[2] + np.sin(col_angles) * dist
        stripe = 0.85 + 0.15 * np.sin(
            40.0 * (hit_x + hit_z))
        col_rgb = col_rgb * (shade * stripe)[:, None]

        img = np.empty((h, h, 3), np.float32)
        img[:] = self.sky_color[None, None, :]
        rows = np.arange(h)[:, None]
        half_h = np.clip((20.0 / dist_c).astype(np.int32), 1, h // 2)
        top = h // 2 - half_h
        bot = h // 2 + half_h
        wall_mask = (rows >= top[None, :]) & (rows < bot[None, :])   # (H, C)
        floor_mask = rows >= bot[None, :]
        img = np.where(wall_mask[:, :, None], col_rgb[None, :, :], img)
        floor_shade = (0.5 + 0.5 * (rows / h)).astype(np.float32)
        floor_rgb = self.floor_color[None, None, :] * floor_shade[:, :, None]
        img = np.where(floor_mask[:, :, None], floor_rgb, img)

        # goal beacon: bright cylinder at the goal, visible through walls
        # only if nearer than the wall hit
        gx, gz = self.goal_position[0] - pos[0], self.goal_position[2] - pos[2]
        g_dist = np.hypot(gx, gz)
        if g_dist > 1e-6:
            g_bearing = np.arctan2(gz, gx)
            ang_err = np.abs(
                (col_angles - g_bearing + np.pi) % (2 * np.pi) - np.pi)
            ang_rad = np.arctan2(0.18, g_dist)
            visible = (ang_err < ang_rad) & (g_dist < dist)
            if visible.any():
                bh = np.clip(int(14.0 / max(g_dist, 0.12)), 2, h // 2)
                beacon_mask = visible[None, :] & \
                    (rows >= h // 2 - bh) & (rows < h // 2 + bh)
                beacon_rgb = np.array([255.0, 40.0, 40.0], np.float32)
                img = np.where(beacon_mask[:, :, None], beacon_rgb, img)

        return np.clip(img, 0, 255).astype(np.uint8)

    # -- expert (greedy geodesic follower) ---------------------------------

    # Waypoint lookahead (cells) for the expert's steering target.
    EXPERT_LOOKAHEAD = 8

    def shortest_path_actions(self, max_steps=None):
        """Action sequence (habitat ids 1..3) from the episode start to
        the goal via greedy descent of the BFS field; the habitat
        ``get_action_shortest_path`` equivalent.  Returns None when no
        path exists (GreedyFollowerError analogue).

        Steering (round-4, VERDICT r3 #4): aims at the farthest
        line-of-sight-visible cell along the geodesic descent (up to
        EXPERT_LOOKAHEAD cells) instead of the adjacent cell.  Chasing
        the adjacent cell's center flips the bearing sign as the agent
        passes near it, producing left/right chatter that is hard for
        BC to imitate (compounding error feeds on incoherent
        supervision); a far waypoint yields long coherent FORWARD runs
        with occasional turn bursts — the same action texture habitat's
        geodesic greedy follower emits."""
        max_steps = max_steps or self.max_episode_steps
        pos = self.start_position.copy()
        heading = getattr(self, "_start_heading", 0.0)
        if not np.isfinite(self._field[self._cell(pos)]):
            return None
        actions = []
        stall = 0
        while len(actions) < max_steps:
            if self._geo_at(pos) <= SUCCESS_DISTANCE:
                break
            target = self._waypoint(pos)
            if target is None:
                return None
            bearing = np.arctan2(target[1] - pos[2], target[0] - pos[0])
            err = (bearing - heading + np.pi) % (2 * np.pi) - np.pi
            if abs(err) <= np.deg2rad(15.0):
                delta = FORWARD_STEP * np.array(
                    [np.cos(heading), 0.0, np.sin(heading)], np.float32)
                cand = pos + delta
                if self.is_navigable(cand) and \
                        self._geo_at(cand) <= self._geo_at(pos) + CELL:
                    pos = cand
                    actions.append(1)
                    stall = 0
                    continue
                err = err if abs(err) > 1e-6 else np.deg2rad(10.0)
            heading += np.sign(err) * np.deg2rad(TURN_ANGLE_DEG)
            actions.append(2 if err > 0 else 3)
            stall += 1
            if stall > 40:
                return None
        return actions

    def _geo_at(self, pos):
        return float(self._field[self._cell(pos)])

    def _descend_from(self, cell):
        x, z = cell
        best, best_d = None, self._field[x, z]
        for dx, dz in ((1, 0), (-1, 0), (0, 1), (0, -1),
                       (1, 1), (1, -1), (-1, 1), (-1, -1)):
            nx, nz = x + dx, z + dz
            if 0 <= nx < GRID and 0 <= nz < GRID and not self.occ[nx, nz]:
                d = self._field[nx, nz]
                if d < best_d:
                    best, best_d = (nx, nz), d
        if best is None:
            return cell if best_d <= CELL else None
        return best

    def _line_of_sight(self, pos, tx, tz):
        dx, dz = tx - pos[0], tz - pos[2]
        dist = float(np.hypot(dx, dz))
        n = max(int(dist / (CELL / 2)), 1)
        for i in range(1, n + 1):
            f = i / n
            if self.occ[self._cell((pos[0] + f * dx, 0.0,
                                    pos[2] + f * dz))]:
                return False
        return True

    def _waypoint(self, pos):
        """(x, z) of the farthest visible cell center along the greedy
        BFS descent, or the adjacent descend cell as fallback."""
        cell = self._cell(pos)
        path = [cell]
        for _ in range(self.EXPERT_LOOKAHEAD):
            nxt = self._descend_from(path[-1])
            if nxt is None or nxt == path[-1]:
                break
            path.append(nxt)
        if len(path) == 1:
            nxt = self._descend_from(cell)
            if nxt is None:
                return None
            path.append(nxt)
        for c in reversed(path[1:]):
            tx, tz = (c[0] + 0.5) * CELL, (c[1] + 0.5) * CELL
            if self._line_of_sight(pos, tx, tz):
                return tx, tz
        c = path[1]
        return (c[0] + 0.5) * CELL, (c[1] + 0.5) * CELL
