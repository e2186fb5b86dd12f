"""Procedural environment generators (the reference's
``mpinets/data_pipeline/environments``): host-side numpy scenes and batched
IK on the device. Port of ``mpinets_tpu/envs``."""

from mpinets_torch.envs.base import (  # noqa: F401
    Candidate,
    Environment,
    NeutralCandidate,
    TaskOrientedCandidate,
    pose_from_xz_axes,
    pose_from_z_axis,
    radius_sample,
)
from mpinets_torch.envs.cubby import CubbyEnvironment, MergedCubbyEnvironment  # noqa: F401
from mpinets_torch.envs.dresser import DresserEnvironment  # noqa: F401
from mpinets_torch.envs.tabletop import TabletopEnvironment  # noqa: F401

#: CLI name -> environment class (gen_data.py's scene-type switch,
#: ``gen_data.py:975-1127``).
ENVIRONMENTS = {
    "tabletop": TabletopEnvironment,
    "cubby": CubbyEnvironment,
    "merged-cubby": MergedCubbyEnvironment,
    "dresser": DresserEnvironment,
}
