"""The one traffic generator: a robot driving a seeded world, as data.

A frozen copy of the world of wild_visual_navigation_tpu_torch/runtime/
replay.py::synthetic_sequence (a textured ground plane seen by a camera
1.2 m up, pitched 45 degrees down; obstacle bands where the robot only
makes 0.15 m/s of its commanded 1 m/s, so velocity tracking fails), made
general by a mix file's parameters:

  * `period_s`: the virtual time between two events of one stream; frame
    i is stamped `i * stamp_step_s`, robot state i 10 ms later, so the
    product's 10 Hz gates pass every event (`stamp_step_s` > `period_s`
    by a hair, against float rounding);
  * `frames`: "render" renders every frame at the robot's pose (the
    images and the supervision geometry agree), on first use or ahead of
    time by `prepare`; "pool" renders `pool_frames` distinct frames along
    the track once and cycles them while the poses advance;
  * `cameras`: frames per event; camera c sits `camera_spacing_m * (c -
    (cameras - 1) / 2)` to the side of the first camera's place;
  * `obstacle_every_m`, `obstacle_first_m`, `obstacle_halfwidth_m`: the
    obstacle bands along the track.

The seed draws the ground texture and the twist noise; sizes, arrivals
and obstacles are the mix's, the same for every seed. Frames are uint8,
as a camera gives them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SPEED = 1.0  # commanded m/s
GRIND = 0.15  # achieved m/s inside an obstacle band
TWIST_NOISE = 0.03


def ground_texture(rng: np.random.RandomState, size: int = 256) -> np.ndarray:
    """Smooth random texture (3, size, size) for the world floor."""
    tex = rng.rand(3, size // 8, size // 8).astype(np.float32)
    tex = tex.repeat(8, axis=1).repeat(8, axis=2)
    for _ in range(2):
        tex = 0.25 * (np.roll(tex, 1, 1) + np.roll(tex, -1, 1) + np.roll(tex, 1, 2) + np.roll(tex, -1, 2))
    return tex


def camera_in_base(lateral_m: float = 0.0) -> np.ndarray:
    """The camera 1.2 m up and 0.3 m ahead of the base, pitched 45 degrees
    down, looking along +x: x_cam = -y_base, y_cam backward-down, z_cam
    forward-down."""
    s, c = np.sin(np.deg2rad(45)), np.cos(np.deg2rad(45))
    T = np.eye(4)
    T[:3, :3] = np.array([[0.0, -s, c], [-1.0, 0.0, 0.0], [0.0, -c, -s]])
    T[:3, 3] = [0.3, lateral_m, 1.2]
    return T


def intrinsics(size: int) -> np.ndarray:
    return np.array([[0.6 * size, 0, size / 2], [0, 0.6 * size, size / 2], [0, 0, 1.0]])


class World:
    """The ground plane, its obstacle bands and the camera's ray cast."""

    def __init__(self, mix: dict, size: int, rng: np.random.RandomState):
        self.tex = ground_texture(rng)
        self.size = size
        self.every = float(mix.get("obstacle_every_m", 0.0))
        self.first = float(mix.get("obstacle_first_m", 6.0))
        self.half = float(mix.get("obstacle_halfwidth_m", 0.5))
        K = intrinsics(size)
        uu, vv = np.meshgrid(np.arange(size) + 0.5, np.arange(size) + 0.5)
        pix = np.stack([uu, vv, np.ones_like(uu)], axis=-1).reshape(-1, 3)
        T = camera_in_base()
        dirs = (T[:3, :3] @ (np.linalg.inv(K) @ pix.T)).T
        dz = dirs[:, 2]
        t_hit = np.where(np.abs(dz) > 1e-6, -T[2, 3] / np.where(np.abs(dz) < 1e-6, 1.0, dz), -1.0)
        self.ground = (t_hit > 0) & (t_hit < 30)
        self.offs_xy = T[:2, 3][None] + t_hit[:, None] * dirs[:, :2]

    def in_obstacle(self, x) -> np.ndarray:
        if self.every <= 0:
            return np.zeros_like(np.asarray(x, dtype=bool))
        d = (np.asarray(x) - self.first) % self.every
        return (np.minimum(d, self.every - d) < self.half) & (np.asarray(x) > self.first - self.half)

    def render(self, x: float, y: float = 0.0) -> np.ndarray:
        """(3, size, size) uint8 pinhole render at base position (x, y)."""
        wx = self.offs_xy[:, 0] + x
        wy = self.offs_xy[:, 1] + y
        ti = (np.abs(wx * 24) % self.tex.shape[1]).astype(int)
        tj = (np.abs((wy + 100) * 24) % self.tex.shape[2]).astype(int)
        cols = self.tex[:, ti, tj]
        cols = np.where(self.in_obstacle(wx)[None], np.array([0.55, 0.08, 0.08], np.float32)[:, None], cols)
        cols = np.where(self.ground[None], cols, np.array([0.65, 0.8, 0.95], np.float32)[:, None])
        return np.round(np.clip(cols, 0, 1) * 255).astype(np.uint8).reshape(3, self.size, self.size)


@dataclass
class Event:
    """Event i: its frames and the robot state that follows them."""

    index: int
    stamp: float
    images: list  # `cameras` (3, H, W) uint8 frames
    pose_base: np.ndarray  # (4, 4)
    state_stamp: float
    current_twist: np.ndarray  # (6,)
    desired_twist: np.ndarray  # (6,)


class Traffic:
    """Events by index, the same for a given (mix, size, seed)."""

    def __init__(self, mix: dict, size: int, seed: int, n_events: int):
        rng = np.random.RandomState(np.random.SeedSequence([seed, 17]).generate_state(1)[0])
        self.mix = mix
        self.size = size
        self.world = World(mix, size, rng)
        self.period = float(mix.get("period_s", 0.1))
        self.stamp_step = float(mix.get("stamp_step_s", self.period * (1 + 1e-6)))
        self.cameras = int(mix.get("cameras", 1))
        spacing = float(mix.get("camera_spacing_m", 0.2))
        self.cam_in_base = [camera_in_base(spacing * (c - (self.cameras - 1) / 2)) for c in range(self.cameras)]
        self.K = intrinsics(size)
        self.Ks = np.stack([self.K] * self.cameras)
        self.n = n_events
        # the track: substeps of a quarter period, the speed set by the bands (a mix without bands skips
        # in_obstacle, which costs microseconds a call: a closed loop's budget is tens of thousands of events)
        sub = self.period / 4
        bands = self.world.every > 0
        xs = np.zeros(n_events)
        x = 0.0
        for i in range(n_events):
            xs[i] = x
            for _ in range(4):
                x += (GRIND if bands and self.world.in_obstacle(x) else SPEED) * sub
        self.xs = xs
        self.noise = rng.randn(n_events, 6) * TWIST_NOISE
        if mix.get("frames", "render") == "pool":
            P = int(mix["pool_frames"])
            spacing_m = float(mix.get("pool_spacing_m", 0.37))
            self.pool = [self.world.render(k * spacing_m) for k in range(P)]
            self.images = None
            B = self.cameras
            self._batches = ([np.stack([self.pool[(k * B + c) % P] for c in range(B)]) for k in range(P // B)]
                             if B > 1 and P % B == 0 else None)
        else:
            self.pool = self._batches = None
            self.images = {}

    def prepare(self, start: int, stop: int) -> None:
        """Render the frames of events [start, stop) now ("render" mode)."""
        if self.images is not None:
            for i in range(start, min(stop, self.n)):
                self._image(i)

    def _image(self, i: int) -> np.ndarray:
        if i not in self.images:
            self.images[i] = self.world.render(float(self.xs[i]))
        return self.images[i]

    def batch(self, i: int) -> np.ndarray:
        """Event i's frames stacked, (cameras, 3, H, W)."""
        if self.pool is not None and self._batches is not None:
            return self._batches[i % len(self._batches)]
        return np.stack(self.event(i).images)

    def event(self, i: int) -> Event:
        x = float(self.xs[i])
        pose = np.eye(4)
        pose[0, 3] = x
        if self.pool is not None:
            P = len(self.pool)
            images = [self.pool[(i * self.cameras + c) % P] for c in range(self.cameras)]
        else:
            images = [self._image(i)] * self.cameras
        desired = np.array([SPEED, 0, 0, 0, 0, 0.0])
        speed = GRIND if self.world.in_obstacle(x) else SPEED
        return Event(index=i, stamp=i * self.stamp_step, images=images, pose_base=pose,
                     state_stamp=i * self.stamp_step + 0.01, current_twist=desired * speed + self.noise[i],
                     desired_twist=desired)
