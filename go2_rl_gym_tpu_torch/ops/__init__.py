"""The port's hand-written CUDA kernels, each beside its plain version:
``terrain_patches`` (the per-env terrain patch copy) and ``rigid_body`` (a
substep's rigid-body dynamics). Each module counts its kernel's host
launches in ``LAUNCHES``."""
from go2_rl_gym_tpu_torch.ops import rigid_body, terrain_patches

KERNEL_MODULES = (terrain_patches, rigid_body)


def launch_counts() -> dict:
    """Host launches of every kernel so far, by kernel name."""
    return {k: v for m in KERNEL_MODULES for k, v in m.LAUNCHES.items()}


def reset_launch_counts():
    for m in KERNEL_MODULES:
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0
