"""Motion representation utilities: rotations, SMPL kinematics."""

from mint_tpu_torch.motion.rotation import (  # noqa: F401
    aa2rotmat,
    euler_from_rotmat,
    get_closest_rotmat,
    recover_to_axis_angles,
    rotmat2aa,
    rotmat2euler,
)
