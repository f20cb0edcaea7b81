"""The port's small modules (ROADMAP.md item 29) against the JAX package,
on the CPU: supervision/twist_dataset.py on a CSV fixture the test writes
(the reference's twist recordings are not in the repository),
utils/meshes.py at fp32 (atol 1e-6: the poses' rotations are summed in
another order), and utils/misc.py, whose test image falls back to the JAX
package's seeded one."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu.supervision import TwistDataModule as JTwistDataModule
from wild_visual_navigation_tpu.supervision import TwistDataset as JTwistDataset
from wild_visual_navigation_tpu.utils import meshes as jmeshes
from wild_visual_navigation_tpu.utils import misc as jmisc
from wild_visual_navigation_tpu_torch.supervision import TwistDataModule, TwistDataset
from wild_visual_navigation_tpu_torch.utils import meshes, misc
from wild_visual_navigation_tpu_torch.utils.lie import se3_exp

MESH_ATOL = 1e-6
HEADER = "#sec,nsec,vx [m/s],vy [m/s],vz [m/s],wx [rad/s],wy [rad/s],wz [rad/s]"


@pytest.fixture(scope="module")
def twist_logs(tmp_path_factory):
    """Current twists at 50 Hz, desired twists at 20 Hz with jitter (some
    beyond the 10 ms match), written unsorted, as a recording's CSVs."""
    root = tmp_path_factory.mktemp("twist")
    rng = np.random.default_rng(0)

    def write(name, stamps):
        rows = [f"{int(t)},{int(round((t - int(t)) * 1e9))}," + ",".join(f"{v:.6f}" for v in rng.standard_normal(6))
                for t in stamps]
        order = rng.permutation(len(rows))
        (root / name).write_text(HEADER + "\n" + "\n".join(rows[i] for i in order) + "\n")

    write("current.csv", 100.0 + np.arange(120) * 0.02)
    write("desired.csv", 100.0 + np.arange(48) * 0.05 + rng.uniform(-0.015, 0.015, 48))
    return str(root)


@pytest.mark.parametrize("mode", ["train", "val"])
def test_twist_dataset_matches_jax(twist_logs, mode):
    kw = dict(mode=mode, seq_size=4)
    want = JTwistDataset(twist_logs, "current.csv", "desired.csv", **kw)
    got = TwistDataset(twist_logs, "current.csv", "desired.csv", **kw)
    assert len(got) == len(want) == (96 if mode == "train" else 24)
    for i in (0, 5, len(got) - 2):  # the last windows clamp to the end
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
    ts, cur, des = got[0]
    assert ts.shape == (4, 1) and cur.shape == (4, 6) and des.shape == (4, 6)
    assert np.all(np.diff(got.timestamps[:, 0]) >= 0) and (got.desired_twist == 0).all(axis=1).any()
    with pytest.raises(ValueError, match="Mode unknown"):
        TwistDataset(twist_logs, "current.csv", "desired.csv", mode="test")


def test_twist_data_module_batches_match_jax(twist_logs):
    got = TwistDataModule(twist_logs, "current.csv", "desired.csv", batch_size=16, seq_size=8)
    want = JTwistDataModule(twist_logs, "current.csv", "desired.csv", batch_size=16, seq_size=8)
    for gen in ("train_batches", "val_batches"):
        pairs = list(zip(getattr(got, gen)(), getattr(want, gen)()))
        assert len(pairs) == len(list(getattr(want, gen)())) > 0
        for g, w in pairs:
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def _pose():
    return se3_exp(torch.tensor([0.3, -0.2, 0.1, 0.2, 0.1, -0.4])).numpy()


@pytest.mark.parametrize("name", ["make_box", "make_rounded_box", "make_ellipsoid"])
@pytest.mark.parametrize("posed", [False, True], ids=["identity", "posed"])
def test_superquadrics_match_jax(name, posed):
    pose = _pose() if posed else None
    want = np.asarray(getattr(jmeshes, name)(1.0, 0.6, 0.3, pose=None if pose is None else jnp.asarray(pose)))
    got = getattr(meshes, name)(1.0, 0.6, 0.3, pose=pose)
    assert got.dtype == torch.float32 and got.shape == (121, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=MESH_ATOL)


@pytest.mark.parametrize("extent", [dict(x=1.0, y=0.5), dict(y=1.0, z=0.5), dict(x=1.0, z=2.0)], ids=["xy", "yz", "xz"])
def test_planes_match_jax(extent):
    pose = _pose()
    for name, n in (("make_plane", 44), ("make_dense_plane", 25)):
        want = np.asarray(getattr(jmeshes, name)(**extent, pose=jnp.asarray(pose)))
        got = getattr(meshes, name)(**extent, pose=pose)
        assert got.shape == (n, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=MESH_ATOL)
    with pytest.raises(ValueError, match="exactly 2"):
        meshes.make_plane(x=1.0, y=1.0, z=1.0)


def test_side_points_and_polygon_match_jax():
    pose = _pose()
    np.testing.assert_allclose(meshes.make_side_points(0.6, pose).numpy(),
                               np.asarray(jmeshes.make_side_points(0.6, jnp.asarray(pose))), atol=MESH_ATOL)
    pts = np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32)
    got = meshes.make_polygon_from_points(torch.from_numpy(pts), grid_size=7)
    assert got.shape == (35, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jmeshes.make_polygon_from_points(jnp.asarray(pts), 7)),
                               atol=MESH_ATOL)


def test_misc_matches_jax(tmp_path, monkeypatch):
    d = {"a": 1, "b": {"c": 2, "d": {"e": 3}}}
    assert misc.flatten_dict(d) == jmisc.flatten_dict(d)
    x = np.random.default_rng(2).standard_normal(50).astype(np.float32)
    np.testing.assert_array_equal(misc.get_confidence(x), jmisc.get_confidence(x))
    np.testing.assert_array_equal(misc.get_confidence(np.ones(4)), np.zeros(4, np.float32))
    folder = misc.create_experiment_folder("run", timestamp=False, root=str(tmp_path))
    assert folder == os.path.join(str(tmp_path), "run") and os.path.isdir(folder)
    assert os.path.dirname(misc.create_experiment_folder("run", root=str(tmp_path))) == folder
    monkeypatch.setattr(misc, "ROOT_DIR", str(tmp_path))
    assert misc.make_results_folder("x") == os.path.join(str(tmp_path), "results", "x") and os.path.isdir(
        os.path.join(str(tmp_path), "results", "x"))


def test_load_test_image_falls_back_to_jax_seeded_image(tmp_path):
    """The reference's fixture is not in the repository: both packages give
    the same seeded 224 x 224 image; a readable file is read as RGB in [0, 1]."""
    got = misc.load_test_image()
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and tuple(got.shape) == (1, 3, 224, 224)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmisc.load_test_image(str(tmp_path / "missing.png"))))
    from PIL import Image

    rgb = np.random.default_rng(3).integers(0, 256, (12, 20, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(tmp_path / "img.png")
    img = misc.load_test_image(str(tmp_path / "img.png"))
    assert tuple(img.shape) == (1, 3, 12, 20)
    np.testing.assert_array_equal(img.numpy(), np.asarray(jmisc.load_test_image(str(tmp_path / "img.png"))))
