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

The reference-shaped object graph serves on top of them: cameras (also the live ones of
``hardware_camera.py``), renderers over a ``RendererGeometry``, the region, depth and
texture modalities, links with hard and soft constraints, optimizers, detectors and
viewers driven by a :class:`Tracker` (``tracker.py``), or built from a config file by
``GenerateConfiguredTracker`` (``generator.py``).  The tracking step runs through the
fused cycle (``fused_serve.FusedServeBackend``) with ``use_fused_cycle=True`` where the
graph allows it, else on the host path.  Its names load lazily, as the JAX package's do;
OpenCV and the camera SDKs are imported only where they run.
"""

import torch

# Pose/geometry math must be exact float32, as m3t_tpu/common.py forces
# jax_default_matmul_precision="highest": TF32 keeps ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_LAZY = {
    "Intrinsics": "m3t_tpu_torch.common",
    "adjoint": "m3t_tpu_torch.common",
    "pose_inverse": "m3t_tpu_torch.common",
    "pose_variation": "m3t_tpu_torch.common",
    "project": "m3t_tpu_torch.common",
    "skew": "m3t_tpu_torch.common",
    "so3_exp": "m3t_tpu_torch.common",
    "so3_log": "m3t_tpu_torch.common",
    "transform_points": "m3t_tpu_torch.common",
    "xcotx": "m3t_tpu_torch.common",
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
    "TextureModality": "m3t_tpu_torch.texture_modality",
    "Constraint": "m3t_tpu_torch.constraint",
    "SoftConstraint": "m3t_tpu_torch.soft_constraint",
    "RendererGeometry": "m3t_tpu_torch.renderer_geometry",
    "IDType": "m3t_tpu_torch.renderer",
    "FocusedBasicDepthRenderer": "m3t_tpu_torch.renderer",
    "FocusedDepthRenderer": "m3t_tpu_torch.renderer",
    "FocusedNormalRenderer": "m3t_tpu_torch.renderer",
    "FocusedSilhouetteRenderer": "m3t_tpu_torch.renderer",
    "FullBasicDepthRenderer": "m3t_tpu_torch.renderer",
    "FullDepthRenderer": "m3t_tpu_torch.renderer",
    "FullNormalRenderer": "m3t_tpu_torch.renderer",
    "FullSilhouetteRenderer": "m3t_tpu_torch.renderer",
    "AzureKinectColorCamera": "m3t_tpu_torch.hardware_camera",
    "AzureKinectDepthCamera": "m3t_tpu_torch.hardware_camera",
    "OpenCVColorCamera": "m3t_tpu_torch.hardware_camera",
    "RealSenseColorCamera": "m3t_tpu_torch.hardware_camera",
    "RealSenseDepthCamera": "m3t_tpu_torch.hardware_camera",
    "Viewer": "m3t_tpu_torch.viewer",
    "ImageColorViewer": "m3t_tpu_torch.viewer",
    "ImageDepthViewer": "m3t_tpu_torch.viewer",
    "NormalColorViewer": "m3t_tpu_torch.viewer",
    "NormalDepthViewer": "m3t_tpu_torch.viewer",
    "GenerateConfiguredTracker": "m3t_tpu_torch.generator",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'm3t_tpu_torch' has no attribute {name!r}")
