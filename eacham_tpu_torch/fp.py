"""Floating-point policy: full fp32 for every matmul and convolution.

The geometry stack (DLT null vectors, triangulation, SE(3) chains) cannot
take reduced-precision passes: in the reference, bf16 passes multiplied
the bench's trajectory error several times over (eacham_tpu/fp.py). On the card,
fp32 matmuls run in full fp32 by default but cuDNN convolutions run in
TF32, so both switches are set off here, at import. The one site that
opts into reduced precision is the descriptor-similarity product
(ops/match_kernel.py: bf16 operands, fp32 accumulation).

Imported for its side effect by the package ``__init__``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
