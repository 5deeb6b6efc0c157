"""Hand-written CUDA kernels of the port, each with its plain PyTorch version."""

# (the differentiable dispatcher is ``ops.attention.attention``; it is not
# re-exported here, where its name would hide the module's)
from eacham_tpu_torch.ops.attention import (  # noqa: F401
    masked_attention, masked_attention_kernel, masked_attention_plain,
)
from eacham_tpu_torch.ops.match_kernel import (  # noqa: F401
    match_pair_fused, match_pair_kernel, match_pair_plain,
    match_pairs_fused, match_pairs_kernel, match_pairs_plain,
)

# kernel name -> wrapper; each wrapper counts its launches in ``.launches``
KERNELS = {"match_pairs": match_pairs_kernel,
           "masked_attention": masked_attention_kernel,
           "match_pair": match_pair_kernel}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {name: k.launches for name, k in KERNELS.items()}
