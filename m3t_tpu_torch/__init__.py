"""PyTorch/CUDA port of m3t_tpu's fused tracking cycles (Hopper kernels in csrc/).

The JAX package ``m3t_tpu`` is the reference; this package imports neither it nor JAX.
Entry points: :func:`m3t_tpu_torch.pipeline.initialize_histograms` with
:func:`m3t_tpu_torch.pipeline.tracking_cycle` or ``tracking_cycle_rgbd`` for rigid
bodies, and ``initialize_kinematic_histograms`` with ``tracking_cycle_kinematic`` for
articulated structures (``ops/kinematics.py``).  Tensors live on the card unless the
caller asks for the CPU, where every kernel runs as its plain PyTorch twin.  Models are
generated on the host (``body.Body``, ``region_model.RegionModel`` and
``depth_model.DepthModel``, whose ``SetUp()`` renders and samples every view with the
g++-built library in ``native/``) and stacked with ``pipeline.RegionModelArrays`` /
``DepthModelArrays.from_models``.
"""

import torch

# Pose/geometry math must be exact float32, as m3t_tpu.common forces
# jax_default_matmul_precision="highest": TF32 keeps ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
