"""Hand-written CUDA kernels of the port, each with its plain PyTorch version."""

from eacham_tpu_torch.ops.match_kernel import (  # noqa: F401
    match_pairs_fused, match_pairs_kernel, match_pairs_plain,
)

# kernel name -> wrapper; each wrapper counts its launches in ``.launches``
KERNELS = {"match_pairs": match_pairs_kernel}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {name: k.launches for name, k in KERNELS.items()}
