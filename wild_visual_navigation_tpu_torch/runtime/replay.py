"""Replay harness: stream recorded/synthetic (image, pose, twist)
sequences through the full online loop without a robot or ROS.

The reference's equivalent is rosbag replay + the Gazebo Jackal sim
(SURVEY.md §4); this harness is the in-repo, deterministic version:
a `Sequence` of timestamped frames and state samples is pumped through
WVNRuntime callbacks in timestamp order at virtual time (no sleeps).
`synthetic_sequence` builds a robot driving over a textured ground
plane with a traversable corridor and an obstacle region where velocity
tracking degrades — enough structure for the online loop to learn a
nontrivial traversability signal end-to-end (BASELINE config 4).

Port of wild_visual_navigation_tpu/runtime/replay.py: numpy plus the
port's WVNRuntime. The maps of `ReplayReport.last_result` stay on the
runtime's device; read them with `InferenceResult.to_numpy`. With a grid
map (`WVNRuntime(gridmap_size > 0)`) `run_closed_loop` steers by the
carrot `get_carrot` picks; without one it drives its initial command.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .runtime import InferenceResult, WVNRuntime


@dataclass
class CameraFrame:
    stamp: float
    camera: str
    image: np.ndarray  # (3, H, W) [0,1]
    K: np.ndarray  # (3, 3)
    pose_base_in_world: np.ndarray
    pose_cam_in_base: np.ndarray


@dataclass
class StateSample:
    stamp: float
    pose_base_in_world: np.ndarray
    current_twist: np.ndarray  # (6,)
    desired_twist: np.ndarray  # (6,)


@dataclass
class Sequence:
    frames: List[CameraFrame] = field(default_factory=list)
    states: List[StateSample] = field(default_factory=list)

    def events(self) -> Iterator[Tuple[float, str, object]]:
        evs = [(f.stamp, "frame", f) for f in self.frames] + [(s.stamp, "state", s) for s in self.states]
        return iter(sorted(evs, key=lambda e: e[0]))


def _ground_texture(rng: np.random.RandomState, size: int = 256) -> np.ndarray:
    """Smooth random texture (3, size, size) for the world floor."""
    tex = rng.rand(3, size // 8, size // 8).astype(np.float32)
    tex = tex.repeat(8, axis=1).repeat(8, axis=2)
    # cheap blur
    for _ in range(2):
        tex = 0.25 * (np.roll(tex, 1, 1) + np.roll(tex, -1, 1) + np.roll(tex, 1, 2) + np.roll(tex, -1, 2))
    return tex


def synthetic_sequence(
    duration: float = 8.0,
    frame_rate: float = 10.0,
    state_rate: float = 10.0,
    image_size: int = 224,
    seed: int = 0,
    obstacle_x: Optional[float] = None,
) -> Sequence:
    """Robot drives along +x at 1 m/s over a textured plane; a green-ish
    corridor is traversable, an optional obstacle band at `obstacle_x`
    causes velocity-tracking failure (untraversable supervision)."""
    rng = np.random.RandomState(seed)
    tex = _ground_texture(rng)
    H = W = image_size
    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1.0]])
    # camera 1.2m up, pitched down 45 deg, looking forward (+x):
    # columns are the camera axes in the base frame —
    # x_cam (image right) = -y_base, y_cam (image down) = backward-down,
    # z_cam (optical axis) = forward-down.
    pitch = np.deg2rad(45)
    s, c = np.sin(pitch), np.cos(pitch)
    R_pitch = np.array(
        [
            [0.0, -s, c],
            [-1.0, 0.0, 0.0],
            [0.0, -c, -s],
        ]
    )
    pose_cam_in_base = np.eye(4)
    pose_cam_in_base[:3, :3] = R_pitch
    pose_cam_in_base[:3, 3] = [0.3, 0.0, 1.2]

    # Precompute the pinhole ground-plane ray cast once (poses only
    # translate along x, so pixel->ground offsets are constant).
    Kinv = np.linalg.inv(K)
    uu, vv = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    pix = np.stack([uu, vv, np.ones_like(uu)], axis=-1).reshape(-1, 3)
    dirs_cam = (Kinv @ pix.T).T
    R_wc = pose_cam_in_base[:3, :3]
    cam_origin = pose_cam_in_base[:3, 3]
    dirs_world = (R_wc @ dirs_cam.T).T
    dz = dirs_world[:, 2]
    t_hit = np.where(np.abs(dz) > 1e-6, -cam_origin[2] / np.where(np.abs(dz) < 1e-6, 1.0, dz), -1.0)
    ground = (t_hit > 0) & (t_hit < 30)
    offs_xy = cam_origin[None, :2] + t_hit[:, None] * dirs_world[:, :2]  # base-frame ground hits

    def render(x_pos: float) -> np.ndarray:
        """True pinhole render of the textured ground plane — the SAME
        camera geometry the supervision reprojection uses, so the
        obstacle band's appearance and its labels coincide exactly. The
        band (when configured) is a distinct dark-red surface; rays that
        miss the ground render as sky."""
        wx = offs_xy[:, 0] + x_pos
        wy = offs_xy[:, 1]
        ti = (np.abs(wx * 24) % tex.shape[1]).astype(int)
        tj = (np.abs((wy + 100) * 24) % tex.shape[2]).astype(int)
        cols = tex[:, ti, tj]  # (3, P)
        if obstacle_x is not None:
            in_band = np.abs(wx - obstacle_x) < 0.5
            cols = np.where(in_band[None, :], np.array([0.55, 0.08, 0.08], np.float32)[:, None], cols)
        sky = np.array([0.65, 0.8, 0.95], np.float32)[:, None]
        cols = np.where(ground[None, :], cols, sky)
        return np.clip(cols.reshape(3, H, W), 0, 1).astype(np.float32)

    # Trajectory: commanded 1 m/s; inside the obstacle band the robot
    # only makes 0.15 m/s (grinding through) — a sustained velocity
    # tracking failure, which is what the supervision KF is tuned for.
    def speed_at(x: float) -> float:
        if obstacle_x is not None and abs(x - obstacle_x) < 0.5:
            return 0.15
        return 1.0

    tick = 1.0 / max(frame_rate, state_rate) / 4.0
    xs_of_t = {}
    x = 0.0
    t = 0.0
    while t <= duration + tick:
        xs_of_t[round(t / tick)] = x
        x += speed_at(x) * tick
        t += tick

    def x_at(t: float) -> float:
        return xs_of_t[min(round(t / tick), max(xs_of_t))]

    seq = Sequence()
    base = np.eye(4)
    n_frames = int(duration * frame_rate)
    for i in range(n_frames):
        t = i / frame_rate
        x = x_at(t)
        pose = base.copy()
        pose[0, 3] = x
        seq.frames.append(
            CameraFrame(
                stamp=t, camera="front", image=render(x), K=K, pose_base_in_world=pose,
                pose_cam_in_base=pose_cam_in_base,
            )
        )
    n_states = int(duration * state_rate)
    for i in range(n_states):
        t = i / state_rate
        x = x_at(t)
        pose = base.copy()
        pose[0, 3] = x
        desired = np.array([1.0, 0, 0, 0, 0, 0])
        current = desired * speed_at(x) + rng.randn(6) * 0.03
        seq.states.append(
            StateSample(stamp=t + 0.01, pose_base_in_world=pose, current_twist=current, desired_twist=desired)
        )
    return seq


def save_sequence(seq: Sequence, path: str) -> str:
    """Persist a sequence as one npz — the framework's 'rosbag': record
    once (from a robot shim or the synthetic generator), replay
    deterministically forever."""
    np.savez_compressed(
        path,
        frame_stamps=np.array([f.stamp for f in seq.frames]),
        frame_cameras=np.array([f.camera for f in seq.frames]),
        frame_images=np.stack([f.image for f in seq.frames]) if seq.frames else np.zeros((0,)),
        frame_K=np.stack([f.K for f in seq.frames]) if seq.frames else np.zeros((0,)),
        frame_pose=np.stack([f.pose_base_in_world for f in seq.frames]) if seq.frames else np.zeros((0,)),
        frame_cam_in_base=np.stack([f.pose_cam_in_base for f in seq.frames]) if seq.frames else np.zeros((0,)),
        state_stamps=np.array([s.stamp for s in seq.states]),
        state_pose=np.stack([s.pose_base_in_world for s in seq.states]) if seq.states else np.zeros((0,)),
        state_twist=np.stack([s.current_twist for s in seq.states]) if seq.states else np.zeros((0,)),
        state_desired=np.stack([s.desired_twist for s in seq.states]) if seq.states else np.zeros((0,)),
    )
    return path


def load_sequence(path: str) -> Sequence:
    d = np.load(path, allow_pickle=False)
    seq = Sequence()
    for i in range(len(d["frame_stamps"])):
        seq.frames.append(CameraFrame(
            stamp=float(d["frame_stamps"][i]), camera=str(d["frame_cameras"][i]),
            image=d["frame_images"][i], K=d["frame_K"][i],
            pose_base_in_world=d["frame_pose"][i], pose_cam_in_base=d["frame_cam_in_base"][i],
        ))
    for i in range(len(d["state_stamps"])):
        seq.states.append(StateSample(
            stamp=float(d["state_stamps"][i]), pose_base_in_world=d["state_pose"][i],
            current_twist=d["state_twist"][i], desired_twist=d["state_desired"][i],
        ))
    return seq


@dataclass
class ReplayReport:
    frames_processed: int = 0
    frames_gated: int = 0
    supervision_updates: int = 0
    train_steps: int = 0
    final_loss: float = float("inf")
    valid_nodes: int = 0
    last_result: Optional[InferenceResult] = None


def run_replay(
    runtime: WVNRuntime,
    sequence: Sequence,
    train_every_state: int = 1,
    verbose: bool = False,
) -> ReplayReport:
    """Pump the sequence through the runtime in timestamp order,
    interleaving learning steps like the reference's learning thread
    (at the supervision rate times `train_every_state`)."""
    report = ReplayReport()
    for stamp, kind, payload in sequence.events():
        if kind == "frame":
            f: CameraFrame = payload
            res = runtime.image_callback(
                f.image, f.stamp, f.camera, f.K, f.image.shape[1], f.image.shape[2],
                f.pose_base_in_world, f.pose_cam_in_base,
            )
            if res is None:
                report.frames_gated += 1
            else:
                report.frames_processed += 1
                report.last_result = res
        else:
            s: StateSample = payload
            if runtime.robot_state_callback(s.stamp, s.pose_base_in_world, s.current_twist, s.desired_twist):
                report.supervision_updates += 1
            for _ in range(train_every_state):
                step_before = runtime.estimator.step
                st = runtime.learning_step()
                # count actual optimizer steps (the estimator's counter),
                # not loss readouts — SystemState carries the last loss
                # BETWEEN logging-cadence ticks, which over-counted when
                # logging_thread_rate < learning_thread_rate
                if runtime.estimator.step > step_before:
                    report.train_steps += 1
                if st.loss_total > 0:
                    report.final_loss = st.loss_total
    report.valid_nodes = runtime.estimator.get_num_valid_nodes()
    if verbose:
        print(report)
    return report


class SimWorld:
    """Interactive 2-D simulator — the framework's Gazebo analogue.

    Where `synthetic_sequence` replays a FIXED trajectory (the rosbag
    analogue), SimWorld renders the same textured ground plane + dark
    obstacle disk for ANY (x, y, yaw) pose and integrates commanded
    twists with a grind model inside the obstacle, so a controller can
    be closed around the runtime (reference: the Jackal Gazebo sim +
    carrot_follower demo, wild_visual_navigation_jackal/launch/sim.launch,
    scripts/carrot_follower.py:30-89)."""

    def __init__(
        self,
        image_size: int = 64,
        seed: int = 0,
        obstacle_xy: Optional[tuple] = (4.0, 0.0),
        obstacle_radius: float = 0.8,
        grind_factor: float = 0.15,
    ):
        rng = np.random.RandomState(seed)
        self._tex = _ground_texture(rng)
        H = W = image_size
        self.K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1.0]])
        self.H = self.W = image_size
        pitch = np.deg2rad(45)
        s, c = np.sin(pitch), np.cos(pitch)
        R_pitch = np.array([[0.0, -s, c], [-1.0, 0.0, 0.0], [0.0, -c, -s]])
        self.pose_cam_in_base = np.eye(4)
        self.pose_cam_in_base[:3, :3] = R_pitch
        self.pose_cam_in_base[:3, 3] = [0.3, 0.0, 1.2]

        Kinv = np.linalg.inv(self.K)
        uu, vv = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
        pix = np.stack([uu, vv, np.ones_like(uu)], axis=-1).reshape(-1, 3)
        dirs_cam = (Kinv @ pix.T).T
        R_wc = self.pose_cam_in_base[:3, :3]
        cam_origin = self.pose_cam_in_base[:3, 3]
        dirs_world = (R_wc @ dirs_cam.T).T
        dz = dirs_world[:, 2]
        t_hit = np.where(np.abs(dz) > 1e-6, -cam_origin[2] / np.where(np.abs(dz) < 1e-6, 1.0, dz), -1.0)
        self._ground = (t_hit > 0) & (t_hit < 30)
        self._offs_xy = cam_origin[None, :2] + t_hit[:, None] * dirs_world[:, :2]  # base frame

        self.obstacle_xy = None if obstacle_xy is None else np.asarray(obstacle_xy, float)
        self.obstacle_radius = obstacle_radius
        self.grind_factor = grind_factor
        self.x, self.y, self.yaw = 0.0, 0.0, 0.0
        self.t = 0.0

    # ------------------------------------------------------------ state
    def pose(self) -> np.ndarray:
        T = np.eye(4)
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        T[:2, :2] = [[cy, -sy], [sy, cy]]
        T[0, 3], T[1, 3] = self.x, self.y
        return T

    def in_obstacle(self, x: float, y: float) -> bool:
        if self.obstacle_xy is None:
            return False
        return float(np.hypot(x - self.obstacle_xy[0], y - self.obstacle_xy[1])) < self.obstacle_radius

    # ----------------------------------------------------------- render
    def render(self, pose: Optional[np.ndarray] = None) -> np.ndarray:
        """(3, H, W) pinhole render of the world from the robot camera —
        the same geometry the supervision reprojection uses."""
        T = self.pose() if pose is None else pose
        R2 = T[:2, :2]
        wxy = self._offs_xy @ R2.T + T[:2, 3][None]
        ti = (np.abs(wxy[:, 0] * 24) % self._tex.shape[1]).astype(int)
        tj = (np.abs((wxy[:, 1] + 100) * 24) % self._tex.shape[2]).astype(int)
        cols = self._tex[:, ti, tj]
        if self.obstacle_xy is not None:
            d = np.hypot(wxy[:, 0] - self.obstacle_xy[0], wxy[:, 1] - self.obstacle_xy[1])
            cols = np.where((d < self.obstacle_radius)[None, :],
                            np.array([0.55, 0.08, 0.08], np.float32)[:, None], cols)
        sky = np.array([0.65, 0.8, 0.95], np.float32)[:, None]
        cols = np.where(self._ground[None, :], cols, sky)
        return np.clip(cols.reshape(3, self.H, self.W), 0, 1).astype(np.float32)

    # ------------------------------------------------------------- step
    def step(self, cmd_twist: np.ndarray, dt: float) -> np.ndarray:
        """Integrate a commanded twist [vx, ., ., ., ., wz]; inside the
        obstacle the achieved linear speed collapses to `grind_factor`
        of the command (sustained velocity-tracking failure — what the
        supervision KF flags untraversable). Returns the ACHIEVED twist."""
        vx, wz = float(cmd_twist[0]), float(cmd_twist[5])
        factor = self.grind_factor if self.in_obstacle(self.x, self.y) else 1.0
        v = vx * factor
        self.x += v * np.cos(self.yaw) * dt
        self.y += v * np.sin(self.yaw) * dt
        self.yaw += wz * dt
        self.t += dt
        achieved = np.zeros(6)
        achieved[0], achieved[5] = v, wz
        return achieved


def run_closed_loop(
    runtime: WVNRuntime,
    world: SimWorld,
    duration: float = 20.0,
    rate: float = 5.0,
    goal_speed: float = 1.0,
    carrot_every: int = 2,
):
    """Close the full navigation loop in-process: render -> inference +
    mission graph -> proprioceptive supervision -> online training ->
    traversability grid map -> smart-carrot goal -> P-controller twist
    -> world step (the reference's Gazebo + carrot_follower demo,
    docker/README.md, without ROS). Returns the driven path and the
    carrot goals chosen."""
    from ..scripts.carrot_follower import FollowerConfig, follow_carrot

    dt = 1.0 / rate
    cmd = np.array([goal_speed, 0, 0, 0, 0, 0.0])
    path = []
    goals = []
    step_i = 0
    while world.t < duration:
        pose = world.pose()
        img = world.render(pose)
        runtime.image_callback(img, world.t, "front", world.K, world.H, world.W,
                               pose, world.pose_cam_in_base)
        achieved = world.step(cmd, dt)
        runtime.robot_state_callback(world.t, world.pose(), achieved, cmd)
        runtime.learning_step()
        path.append((world.t, world.x, world.y, world.yaw))
        step_i += 1
        if runtime.gridmap is not None and step_i % carrot_every == 0:
            goal, _ = runtime.get_carrot(yaw=world.yaw)
            goals.append(goal)
            if goal is not None:
                tw = follow_carrot(world.pose(), goal, FollowerConfig(max_linear=goal_speed))
                if tw[0] > 0.05 or abs(tw[5]) > 1e-3:
                    cmd = np.array([max(tw[0], 0.2), 0, 0, 0, 0, tw[5]])
    return np.asarray(path), goals
