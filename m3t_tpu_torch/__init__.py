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

The reference-shaped object graph serves on top of them: cameras, modalities, links,
optimizers and detectors driven by a :class:`Tracker` (``tracker.py``), whose tracking
step runs through the fused cycle (``fused_serve.FusedServeBackend``) with
``use_fused_cycle=True``.  Its names load lazily, as the JAX package's do.
"""

import torch

# Pose/geometry math must be exact float32, as m3t_tpu.common forces
# jax_default_matmul_precision="highest": TF32 keeps ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_LAZY = {
    "Body": "m3t_tpu_torch.body",
    "Camera": "m3t_tpu_torch.camera",
    "ColorCamera": "m3t_tpu_torch.camera",
    "DepthCamera": "m3t_tpu_torch.camera",
    "ImageColorCamera": "m3t_tpu_torch.camera",
    "ImageDepthCamera": "m3t_tpu_torch.camera",
    "LoaderColorCamera": "m3t_tpu_torch.camera",
    "LoaderDepthCamera": "m3t_tpu_torch.camera",
    "ColorHistograms": "m3t_tpu_torch.color_histograms",
    "RegionModel": "m3t_tpu_torch.region_model",
    "DepthModel": "m3t_tpu_torch.depth_model",
    "Modality": "m3t_tpu_torch.modality",
    "RegionModality": "m3t_tpu_torch.region_modality",
    "DepthModality": "m3t_tpu_torch.depth_modality",
    "Link": "m3t_tpu_torch.link",
    "Optimizer": "m3t_tpu_torch.optimizer",
    "Detector": "m3t_tpu_torch.detector",
    "StaticDetector": "m3t_tpu_torch.detector",
    "ManualDetector": "m3t_tpu_torch.detector",
    "Refiner": "m3t_tpu_torch.refiner",
    "Publisher": "m3t_tpu_torch.publisher",
    "Subscriber": "m3t_tpu_torch.subscriber",
    "Tracker": "m3t_tpu_torch.tracker",
    "FusedServeBackend": "m3t_tpu_torch.fused_serve",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'm3t_tpu_torch' has no attribute {name!r}")
