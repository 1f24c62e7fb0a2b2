"""mpbp_tpu_torch: the PyTorch/CUDA port of `mpbp_tpu` for NVIDIA Hopper.

Same module layout and names as the JAX package, which stays the reference
the port is tested against. Every public constructor and driver takes an
explicit `device=`; nothing here picks a device on its own. The solve
entry points default to float64, as the JAX package does with x64 enabled.

Numeric policy, set once on import: TF32 is off for every float32 matmul
and convolution. TF32 keeps ~3 decimal digits, the GPU form of the bf16
hazard the JAX package guards against (`mpbp_tpu/solvers/gmres.py`
`_tdot`, `mpbp_tpu/solvers/multigrid.py` `_hi_mv`): the f32 inner-GMRES
Arnoldi projections and the coarse-grid pseudo-inverse products are
matmuls, and a 3-digit projection stalls Gram-Schmidt on these
ill-conditioned blocks.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
