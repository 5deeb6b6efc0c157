"""eacham_tpu_torch — the PyTorch/CUDA port of eacham_tpu for NVIDIA Hopper.

The package mirrors ``eacham_tpu``'s layout module for module; the JAX
package stays the reference each piece is checked against. Plain tensor
code is PyTorch; the Pallas kernels of the reference become hand-written
CUDA kernels under ``csrc/`` (built with nvcc at first use), each with a
plain PyTorch version beside it.

Entry points (``features.frontend.extract_features``,
``features.deep.frontend.load_frontend_params`` / ``extract_deep_batch`` /
``build_match_tables_deep``, ``sfm.pipeline.initialize_sfm`` / ``run_sfm`` /
``resume_sfm``, ``sfm.streaming.StreamingReconstructor``,
``io.checkpoint.load_scene`` and the command line ``cli``) run on the card
by default and raise when there is none; pass ``device="cpu"`` (``--device
cpu``) to run the plain versions on the CPU.
"""

import eacham_tpu_torch.fp  # noqa: F401  (fp32 matmul/conv policy)

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API, as the reference's: ``run_sfm``, ``resume_sfm``,
    ``SfmOptions``, ``load_config``, ``SfmConfig``."""
    if name in ("run_sfm", "resume_sfm", "SfmOptions"):
        from eacham_tpu_torch import sfm

        return getattr(sfm, name)
    if name in ("load_config", "SfmConfig"):
        from eacham_tpu_torch.io import config

        return getattr(config, name)
    raise AttributeError(name)
