"""Rotation conversions on torch tensors (the port's counterpart of
``mint_tpu/motion/rotation.py``).

The reference's ``tools/conversion_util.py`` surface (aa2rotmat, rotmat2aa,
rotmat2euler, get_closest_rotmat) and the scorer's motion recovery
(``tools/calculate_scores.py:42-51``), with the numerics of
scipy.spatial.transform.Rotation, as the JAX functions have them.

Every function takes a tensor of any batch shape and computes in its dtype
on its device (f32 on the scoring path, where the JAX package runs f32).
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-8


def aa2rotmat(angles: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 9] (Rodrigues).

    Matches ``Rotation.from_rotvec(...).as_matrix()``
    (conversion_util.py:78-97).
    """
    if angles.shape[-1] != 3:
        raise ValueError(f"aa2rotmat: want [..., 3], got {tuple(angles.shape)}")
    batch = angles.shape[:-1]
    theta = torch.linalg.vector_norm(angles, dim=-1, keepdim=True)
    # Safe normalise; for theta ~ 0 use first-order Rodrigues.
    axis = angles / theta.clamp_min(_EPS)
    x, y, z = axis.unbind(-1)
    zeros = torch.zeros_like(x)
    K = torch.stack([zeros, -z, y,
                     z, zeros, -x,
                     -y, x, zeros], dim=-1).reshape(batch + (3, 3))
    t = theta[..., None]
    eye = torch.eye(3, dtype=angles.dtype, device=angles.device).expand(
        batch + (3, 3))
    R = eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)
    # Near zero angle: R ~= I + skew(angles) (exact to O(theta^2)).
    R_small = eye + K * t
    R = torch.where(t < 1e-6, R_small, R)
    return R.reshape(batch + (9,))


def _as_matrices(rotmats: torch.Tensor) -> Tuple[torch.Tensor, tuple, tuple]:
    shape = tuple(rotmats.shape)
    if shape[-2:] == (3, 3):
        batch = shape[:-2]
    elif shape[-1] == 9:
        batch = shape[:-1]
    else:
        raise ValueError(f"want [..., 3, 3] or [..., 9], got {shape}")
    return rotmats.reshape(batch + (3, 3)), batch, shape


def rotmat2quat(rotmats: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] or [..., 9] -> quaternions [..., 4]
    (x, y, z, w), the branch of the largest diagonal/trace term (Shepperd's
    method)."""
    m, batch, _ = _as_matrices(rotmats)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(qw.clamp_min(0.0))
    # The first of equal maxima, as jnp.argmax picks.
    case = torch.argmax(qw, dim=-1)

    s = 2.0 * qw
    s_w, s_x, s_y, s_z = s.unbind(-1)
    quats = torch.stack([
        torch.stack([(m21 - m12) / s_w, (m02 - m20) / s_w,
                     (m10 - m01) / s_w, 0.25 * s_w], dim=-1),
        torch.stack([0.25 * s_x, (m01 + m10) / s_x,
                     (m02 + m20) / s_x, (m21 - m12) / s_x], dim=-1),
        torch.stack([(m01 + m10) / s_y, 0.25 * s_y,
                     (m12 + m21) / s_y, (m02 - m20) / s_y], dim=-1),
        torch.stack([(m02 + m20) / s_z, (m12 + m21) / s_z,
                     0.25 * s_z, (m10 - m01) / s_z], dim=-1),
    ], dim=-2)  # [..., case, 4]; the branches not picked may hold inf
    index = case[..., None, None].expand(batch + (1, 4))
    q = torch.gather(quats, -2, index)[..., 0, :]
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / norm.clamp_min(_EPS)


def rotmat2aa(rotmats: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] or [..., 9] -> axis-angle [..., 3].

    Matches ``Rotation.from_matrix(...).as_rotvec()``
    (conversion_util.py:50-75), including the angle range [0, pi].
    """
    _, batch, _ = _as_matrices(rotmats)
    q = rotmat2quat(rotmats)
    # scipy canonicalises w >= 0 for as_rotvec.
    q = torch.where(q[..., 3:4] < 0, -q, q)
    xyz = q[..., :3]
    w = q[..., 3].clamp(-1.0, 1.0)
    norm_xyz = torch.linalg.vector_norm(xyz, dim=-1)
    angle = 2.0 * torch.atan2(norm_xyz, w)
    # scale = angle / sin(angle / 2); a Taylor term for small angles.
    sin_half = torch.sin(angle / 2.0)
    scale = torch.where(angle < 1e-6, 2.0 + angle ** 2 / 12.0,
                        angle / sin_half.clamp_min(_EPS))
    return (xyz * scale[..., None]).reshape(batch + (3,))


def euler_from_rotmat(rotmats: torch.Tensor) -> torch.Tensor:
    """R = Rz(z) @ Ry(y) @ Rx(x) -> [..., 3] angles (x, y, z).

    The convention of ``tfg.euler.from_rotation_matrix`` that the reference
    metric uses (mint/core/metrics.py:45-48).  Gimbal-locked inputs
    (|r20| ~ 1) resolve with z = 0.
    """
    m, batch, _ = _as_matrices(rotmats)
    r00, r10, r20 = m[..., 0, 0], m[..., 1, 0], m[..., 2, 0]
    r21, r22 = m[..., 2, 1], m[..., 2, 2]
    r01, r02 = m[..., 0, 1], m[..., 0, 2]
    sy = torch.sqrt(r00 * r00 + r10 * r10)
    gimbal = sy < 1e-6
    # Gimbal branch (tfg): the sign of r20 applies to BOTH arguments of
    # atan2; on one argument only it would negate x at y = +pi/2.
    sign = torch.sign(r20)
    x = torch.where(gimbal, torch.atan2(-sign * r01, -sign * r02),
                    torch.atan2(r21, r22))
    y = torch.atan2(-r20, sy)
    z = torch.where(gimbal, torch.zeros_like(x), torch.atan2(r10, r00))
    return torch.stack([x, y, z], dim=-1).reshape(batch + (3,))


def rotmat2euler(rotmats: torch.Tensor, seq: str = "XYZ") -> torch.Tensor:
    """Rotation matrices -> Euler angles of the intrinsic Tait-Bryan `seq`.

    Matches ``Rotation.from_matrix(...).as_euler(seq)``
    (conversion_util.py:20-48) for the two sequences the reference tools
    use, intrinsic 'XYZ' and 'ZYX'.
    """
    m, batch, _ = _as_matrices(rotmats)
    if seq == "XYZ":
        # R = Rx(a) @ Ry(b) @ Rz(c).
        b = torch.asin(m[..., 0, 2].clamp(-1.0, 1.0))
        a = torch.atan2(-m[..., 1, 2], m[..., 2, 2])
        c = torch.atan2(-m[..., 0, 1], m[..., 0, 0])
        gimbal = m[..., 0, 2].abs() > 1.0 - 1e-7
        a_lock = torch.atan2(m[..., 2, 1], m[..., 1, 1])
    elif seq == "ZYX":
        b = torch.asin((-m[..., 2, 0]).clamp(-1.0, 1.0))
        a = torch.atan2(m[..., 1, 0], m[..., 0, 0])
        c = torch.atan2(m[..., 2, 1], m[..., 2, 2])
        gimbal = m[..., 2, 0].abs() > 1.0 - 1e-7
        a_lock = torch.atan2(-m[..., 0, 1], m[..., 1, 1])
    else:
        raise NotImplementedError(f"euler seq {seq!r}")
    a = torch.where(gimbal, a_lock, a)
    c = torch.where(gimbal, torch.zeros_like(c), c)
    return torch.stack([a, b, c], dim=-1).reshape(batch + (3,))


def get_closest_rotmat(rotmats: torch.Tensor) -> torch.Tensor:
    """Orthogonal projection to SO(3): R = U diag(1, 1, sign(det(UV'))) V'.

    Matches ``conversion_util.get_closest_rotmat``
    (conversion_util.py:100-135) and the scorer's copy
    (calculate_scores.py:21-39).  On a CUDA tensor the batched SVD is
    cuSOLVER's.
    """
    m, batch, shape = _as_matrices(rotmats)
    u, _, vh = torch.linalg.svd(m)
    det = torch.linalg.det(u @ vh)
    fix = torch.cat([torch.ones(batch + (2,), dtype=m.dtype,
                                device=m.device),
                     torch.sign(det)[..., None]], dim=-1)
    return ((u * fix[..., None, :]) @ vh).reshape(shape)


def recover_to_axis_angles(motion: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, 225] FACT motion -> (axis-angles [B, T, 24, 3], translation
    [B, T, 3]): the scorer's recovery (calculate_scores.py:42-51), the
    translation at dims 6:9 and 24 rotation matrices from dim 9 on,
    projected to valid rotations."""
    b, t, dim = motion.shape
    if dim != 225:
        raise ValueError(f"recover_to_axis_angles: want 225-dim motion, got "
                         f"{dim}")
    transl = motion[:, :, 6:9]
    rotmats = get_closest_rotmat(motion[:, :, 9:].reshape(b, t, 24, 3, 3))
    return rotmat2aa(rotmats).reshape(b, t, 24, 3), transl
