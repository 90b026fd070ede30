"""The port's rotations and SMPL kinematics (``mint_tpu_torch/motion``)
against ``mint_tpu.motion`` on the same f32 inputs (CPU)."""

import pickle
import sys
import types

import numpy as np
import pytest
import scipy.sparse
import torch
from scipy.spatial.transform import Rotation

from mint_tpu.motion import rotation as jax_rot
from mint_tpu.motion import smpl as jax_smpl
from mint_tpu_torch.motion import rotation as rot
from mint_tpu_torch.motion import smpl

# f32 on both sides, the same formulas: what is left is the order and
# fusion of a few f32 operations (and LAPACK's SVD against XLA's).
ATOL = 1e-5
RNG = np.random.default_rng(5)


def _rotvecs(n, lo=0.0, hi=np.pi * 0.999):
    axis = RNG.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return (axis * RNG.uniform(lo, hi, (n, 1))).astype(np.float32)


def _matrices(aa):
    return Rotation.from_rotvec(aa).as_matrix().astype(np.float32)


def _gimbal_matrices():
    """Rotations with y = +-pi/2 exactly in both Euler conventions the
    port computes: R = Rz Ry Rx (|r20| = 1), XYZ (|m02| = 1), ZYX."""
    out = []
    for y in (np.pi / 2, -np.pi / 2):
        for x, z in ((0.3, -0.2), (1.1, 0.4), (-2.0, 0.0)):
            cx, sx, cz, sz = np.cos(x), np.sin(x), np.cos(z), np.sin(z)
            cy, sy = 0.0, np.sin(y)  # cos is exactly 0 at the lock
            rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
            ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            out += [rz @ ry @ rx, rx @ ry @ rz]
    return np.stack(out).astype(np.float32)


CASES = {
    "random": lambda: _rotvecs(256),
    "tiny_angle": lambda: _rotvecs(32, 0.0, 9e-7),
    "zero": lambda: np.zeros((4, 3), np.float32),
    "near_pi": lambda: _rotvecs(64, np.pi - 1e-3, np.pi),
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("case", sorted(CASES))
def test_aa2rotmat_matches_jax(case):
    aa = CASES[case]()
    want = np.asarray(jax_rot.aa2rotmat(aa))
    got = rot.aa2rotmat(_t(aa)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rotmat2aa_and_quat_match_jax(case):
    R = _matrices(CASES[case]())
    for fn in ("rotmat2quat", "rotmat2aa"):
        want = np.asarray(getattr(jax_rot, fn)(R))
        got = getattr(rot, fn)(_t(R)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=fn)
    # Flat [..., 9] input too.
    np.testing.assert_allclose(
        rot.rotmat2aa(_t(R.reshape(-1, 9))).numpy(),
        np.asarray(jax_rot.rotmat2aa(R.reshape(-1, 9))), atol=ATOL, rtol=0)


@pytest.mark.parametrize("gimbal", [False, True])
def test_euler_matches_jax(gimbal):
    R = _gimbal_matrices() if gimbal else _matrices(_rotvecs(128))
    np.testing.assert_allclose(
        rot.euler_from_rotmat(_t(R)).numpy(),
        np.asarray(jax_rot.euler_from_rotmat(R)), atol=ATOL, rtol=0)
    for seq in ("XYZ", "ZYX"):
        np.testing.assert_allclose(
            rot.rotmat2euler(_t(R), seq).numpy(),
            np.asarray(jax_rot.rotmat2euler(R, seq)), atol=ATOL, rtol=0,
            err_msg=seq)
    with pytest.raises(NotImplementedError):
        rot.rotmat2euler(_t(R), "XZY")


def test_closest_rotmat_matches_jax_on_non_orthogonal_input():
    R = _matrices(_rotvecs(200))
    noisy = R + 0.1 * RNG.standard_normal(R.shape).astype(np.float32)
    # Reflections too: det < 0 before the projection.
    noisy[::7] *= -1
    for x in (noisy, noisy.reshape(-1, 9)):
        want = np.asarray(jax_rot.get_closest_rotmat(x))
        got = rot.get_closest_rotmat(_t(x)).numpy()
        assert got.shape == x.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    proj = rot.get_closest_rotmat(_t(noisy)).numpy().astype(np.float64)
    np.testing.assert_allclose(np.linalg.det(proj), 1.0, atol=1e-5)


def test_recover_to_axis_angles_matches_jax():
    b, t = 2, 5
    motion = RNG.standard_normal((b, t, 225)).astype(np.float32)
    motion[:, :, 9:] = (_matrices(_rotvecs(b * t * 24)).reshape(b, t, 216)
                        + 0.05 * RNG.standard_normal((b, t, 216)))
    aa_w, tr_w = jax_rot.recover_to_axis_angles(motion)
    aa, tr = rot.recover_to_axis_angles(_t(motion))
    assert aa.shape == (b, t, 24, 3) and tr.shape == (b, t, 3)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(tr_w))
    np.testing.assert_allclose(aa.numpy(), np.asarray(aa_w), atol=ATOL,
                               rtol=0)
    with pytest.raises(ValueError):
        rot.recover_to_axis_angles(_t(motion[..., :100]))


# -- SMPL ---------------------------------------------------------------------

def test_constants_are_the_jax_packages():
    np.testing.assert_array_equal(smpl.SMPL_PARENTS, jax_smpl.SMPL_PARENTS)
    assert smpl.SMPL_JOINT_NAMES == jax_smpl.SMPL_JOINT_NAMES
    np.testing.assert_array_equal(smpl.default_rest_joints(),
                                  jax_smpl.default_rest_joints())


def _poses(shape):
    return RNG.uniform(-0.8, 0.8, shape + (24, 3)).astype(np.float32)


@pytest.mark.parametrize("shape", [(3,), (2, 7)])
def test_fk_matches_jax_on_rest_joints(shape):
    poses = _poses(shape)
    transl = RNG.standard_normal(shape + (3,)).astype(np.float32)
    want = np.asarray(jax_smpl.smpl_joints(poses, transl))
    got = smpl.smpl_joints(poses, transl, device="cpu")
    assert got.dtype == torch.float32 and got.shape == shape + (24, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # f64 arrays are taken to f32, as jnp.asarray takes them.
    np.testing.assert_allclose(
        smpl.smpl_joints(poses.astype(np.float64), transl.astype(np.float64),
                         device="cpu").numpy(), want, atol=ATOL, rtol=0)


def _chumpy_pickle(path, n_verts=60, seed=0):
    """An SMPL-like pickle whose arrays are chumpy objects (a class from a
    module named ``chumpy``, which is not installed) and a sparse
    J_regressor, as the released SMPL_MALE.pkl stores them."""
    rng = np.random.default_rng(seed)

    class Ch:
        pass

    module = types.ModuleType("chumpy.ch")
    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    module.Ch = Ch

    def ch(array):
        obj = Ch()
        obj.x = array
        return obj

    reg = rng.uniform(0, 1, (24, n_verts)) * (rng.uniform(0, 1, (24, n_verts))
                                               < 0.2)
    reg /= np.maximum(reg.sum(1, keepdims=True), 1e-9)
    parents = smpl.SMPL_PARENTS.astype(np.int64)
    parents[0] = 4294967295  # the released file's root: uint32 -1
    kintree = np.stack([parents, np.arange(24)])
    data = {"v_template": ch(rng.standard_normal((n_verts, 3)) * 0.5),
            "shapedirs": ch(rng.standard_normal((n_verts, 3, 10)) * 0.01),
            "J_regressor": scipy.sparse.csc_matrix(reg),
            "kintree_table": kintree,
            "weights": ch(rng.uniform(0, 1, (n_verts, 24)))}
    saved = {k: sys.modules.get(k) for k in ("chumpy", "chumpy.ch")}
    sys.modules["chumpy"] = types.ModuleType("chumpy")
    sys.modules["chumpy.ch"] = module
    try:
        with open(path, "wb") as f:
            pickle.dump(data, f, protocol=2)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


@pytest.mark.parametrize("betas", [None, np.linspace(-1, 1, 10)])
def test_load_smpl_and_fk_match_jax(tmp_path, betas):
    path = str(tmp_path / "smpl.pkl")
    _chumpy_pickle(path)
    assert "chumpy" not in sys.modules
    model = smpl.load_smpl(path, betas)
    want_model = jax_smpl.load_smpl(path, betas)
    assert model.j_rest.dtype == np.float32
    np.testing.assert_array_equal(model.j_rest, want_model.j_rest)
    np.testing.assert_array_equal(model.parents, want_model.parents)
    poses, transl = _poses((5,)), np.zeros((5, 3), np.float32)
    np.testing.assert_allclose(
        smpl.smpl_joints(poses, transl, model, device="cpu").numpy(),
        np.asarray(jax_smpl.smpl_joints(poses, transl, want_model)),
        atol=ATOL, rtol=0)


def test_fk_defaults_to_the_card():
    """Without ``device`` the kinematics ask for CUDA: where there is no
    card that raises, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        smpl.smpl_joints(_poses((1,)), np.zeros((1, 3), np.float32))
