from .ocean import (
    OceanFields,
    OceanState,
    downsample_state,
    make_rollout,
    make_step,
    make_uniform_rollout,
    ocean_state_from_assets,
    ocean_state_from_phillips,
    state_from_numpy,
    step,
)

__all__ = [
    "OceanFields",
    "OceanState",
    "downsample_state",
    "make_rollout",
    "make_step",
    "make_uniform_rollout",
    "ocean_state_from_assets",
    "ocean_state_from_phillips",
    "state_from_numpy",
    "step",
]
