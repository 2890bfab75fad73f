"""Generator: YAML config to tracker object graph (port of m3t_tpu/generator.py;
reference m3t/include/m3t/generator.h).

Parses the reference's generator YAML schema (class-name sections with name/metafile_path/
reference keys, documented in M3T/doc/high_level/generator.md) with the port's
FileStorage reader (``utils/yaml_io``), so that unmodified reference config files build
the equivalent object graph here (generator.h:942-1133) without OpenCV.  Every object
that holds tensors (histograms, modalities, renderer geometries and renderers) is made
on ``device``.
"""

from __future__ import annotations

import os

from m3t_tpu_torch.body import Body
from m3t_tpu_torch.camera import LoaderColorCamera, LoaderDepthCamera
from m3t_tpu_torch.color_histograms import ColorHistograms
from m3t_tpu_torch.common import resolve_device
from m3t_tpu_torch.constraint import Constraint
from m3t_tpu_torch.depth_modality import DepthModality
from m3t_tpu_torch.depth_model import DepthModel
from m3t_tpu_torch.detector import ManualDetector, StaticDetector
from m3t_tpu_torch.link import Link
from m3t_tpu_torch.optimizer import Optimizer
from m3t_tpu_torch.refiner import Refiner
from m3t_tpu_torch.region_modality import RegionModality
from m3t_tpu_torch.region_model import RegionModel
from m3t_tpu_torch.renderer import (
    FocusedBasicDepthRenderer,
    FocusedSilhouetteRenderer,
    IDType,
)
from m3t_tpu_torch.renderer_geometry import RendererGeometry
from m3t_tpu_torch.soft_constraint import SoftConstraint
from m3t_tpu_torch.texture_modality import TextureModality
from m3t_tpu_torch.tracker import Tracker
from m3t_tpu_torch.utils.yaml_io import open_yaml_file_storage
from m3t_tpu_torch.viewer import (
    ImageColorViewer,
    ImageDepthViewer,
    NormalColorViewer,
    NormalDepthViewer,
)


class GeneratorError(RuntimeError):
    pass


def _nodes(fs: dict, class_name: str) -> list[dict]:
    node = fs.get(class_name)
    if node is None:
        return []
    out = node if isinstance(node, list) else [node]
    return [o for o in out if isinstance(o, dict)]


def _require(entry: dict, class_name: str, keys: list[str]) -> None:
    for key in keys:
        if key not in entry or entry[key] is None:
            raise GeneratorError(
                f'Required parameter "{key}" was not configured for {class_name}')


def _metafile(entry: dict, configfile_path: str) -> str | None:
    path = entry.get("metafile_path")
    if not path:
        return None
    if not os.path.isabs(path):
        path = os.path.join(os.path.dirname(os.path.abspath(configfile_path)), path)
    return path


def _get(name: str, ptrs: list, parameter: str, class_name: str):
    for p in ptrs:
        if p.name == name:
            return p
    raise GeneratorError(
        f"Object {name} in {parameter}, {class_name} does not exist.")


def _get_all(names, ptrs, parameter: str, class_name: str) -> list:
    if names is None:
        return []
    if isinstance(names, str):
        names = [names]
    return [_get(n, ptrs, parameter, class_name) for n in names]


def GenerateConfiguredTracker(configfile_path: str, device="cuda") -> Tracker:  # noqa: N802
    """The Tracker that the config file describes, with its objects that hold tensors
    on ``device`` (the card unless the caller asks for the CPU)."""
    return _generate(open_yaml_file_storage(configfile_path), str(configfile_path),
                     resolve_device(device))


def _generate(fs: dict, configfile_path: str, device) -> Tracker:
    # Bodies
    bodies = []
    for e in _nodes(fs, "Body"):
        _require(e, "Body", ["name", "metafile_path"])
        bodies.append(Body(e["name"], metafile_path=_metafile(e, configfile_path)))

    # Color histograms
    histograms = []
    for e in _nodes(fs, "ColorHistograms"):
        _require(e, "ColorHistograms", ["name"])
        histograms.append(ColorHistograms(
            e["name"], metafile_path=_metafile(e, configfile_path), device=device))

    # Renderer geometries
    renderer_geometries = []
    for e in _nodes(fs, "RendererGeometry"):
        _require(e, "RendererGeometry", ["name", "bodies"])
        rg = RendererGeometry(e["name"], device=device)
        for body in _get_all(e["bodies"], bodies, "bodies", "RendererGeometry"):
            rg.AddBody(body)
        renderer_geometries.append(rg)

    # Cameras
    color_cameras = []
    for e in _nodes(fs, "LoaderColorCamera"):
        _require(e, "LoaderColorCamera", ["name", "metafile_path"])
        color_cameras.append(LoaderColorCamera(
            e["name"], metafile_path=_metafile(e, configfile_path)))
    depth_cameras = []
    for e in _nodes(fs, "LoaderDepthCamera"):
        _require(e, "LoaderDepthCamera", ["name", "metafile_path"])
        depth_cameras.append(LoaderDepthCamera(
            e["name"], metafile_path=_metafile(e, configfile_path)))
    # Live cameras: metafile optional (reference generator.h:972-996,
    # ConfigureObjectsMetafileOptional).
    for class_name, camera_list in (("AzureKinectColorCamera", color_cameras),
                                    ("AzureKinectDepthCamera", depth_cameras),
                                    ("RealSenseColorCamera", color_cameras),
                                    ("RealSenseDepthCamera", depth_cameras)):
        for e in _nodes(fs, class_name):
            _require(e, class_name, ["name"])
            from m3t_tpu_torch import hardware_camera

            cls = getattr(hardware_camera, class_name)
            metafile = (_metafile(e, configfile_path)
                        if e.get("metafile_path") else None)
            camera_list.append(cls(e["name"], metafile_path=metafile))
    cameras = color_cameras + depth_cameras

    # Focused renderers
    focused_depth_renderers = []
    for e in _nodes(fs, "FocusedBasicDepthRenderer"):
        _require(e, "FocusedBasicDepthRenderer",
                 ["name", "renderer_geometry", "camera", "referenced_bodies"])
        rg = _get(e["renderer_geometry"], renderer_geometries, "renderer_geometry",
                  "FocusedBasicDepthRenderer")
        cam = _get(e["camera"], cameras, "camera", "FocusedBasicDepthRenderer")
        renderer = FocusedBasicDepthRenderer(e["name"], rg, cam, device=device)
        for body in _get_all(e["referenced_bodies"], bodies, "referenced_bodies",
                             "FocusedBasicDepthRenderer"):
            renderer.AddReferencedBody(body)
        focused_depth_renderers.append(renderer)
    focused_silhouette_renderers = []
    for e in _nodes(fs, "FocusedSilhouetteRenderer"):
        _require(e, "FocusedSilhouetteRenderer",
                 ["name", "renderer_geometry", "camera", "referenced_bodies"])
        rg = _get(e["renderer_geometry"], renderer_geometries, "renderer_geometry",
                  "FocusedSilhouetteRenderer")
        cam = _get(e["camera"], cameras, "camera", "FocusedSilhouetteRenderer")
        id_type = IDType.REGION if e.get("id_type") == "region" else IDType.BODY
        renderer = FocusedSilhouetteRenderer(e["name"], rg, cam, id_type=id_type,
                                             device=device)
        for body in _get_all(e["referenced_bodies"], bodies, "referenced_bodies",
                             "FocusedSilhouetteRenderer"):
            renderer.AddReferencedBody(body)
        focused_silhouette_renderers.append(renderer)
    all_depth_renderers = focused_depth_renderers + focused_silhouette_renderers

    # Models
    region_models = []
    for e in _nodes(fs, "RegionModel"):
        _require(e, "RegionModel", ["name", "metafile_path", "body"])
        body = _get(e["body"], bodies, "body", "RegionModel")
        model = RegionModel(e["name"], body, model_path="INFER",
                            metafile_path=_metafile(e, configfile_path))
        for b in _get_all(e.get("fixed_bodies"), bodies, "fixed_bodies", "RegionModel"):
            model.AddAssociatedBody(b, movable=False, same_region=False)
        for b in _get_all(e.get("movable_bodies"), bodies, "movable_bodies",
                          "RegionModel"):
            model.AddAssociatedBody(b, movable=True, same_region=False)
        for b in _get_all(e.get("fixed_same_region_bodies"), bodies,
                          "fixed_same_region_bodies", "RegionModel"):
            model.AddAssociatedBody(b, movable=False, same_region=True)
        for b in _get_all(e.get("movable_same_region_bodies"), bodies,
                          "movable_same_region_bodies", "RegionModel"):
            model.AddAssociatedBody(b, movable=True, same_region=True)
        region_models.append(model)
    depth_models = []
    for e in _nodes(fs, "DepthModel"):
        _require(e, "DepthModel", ["name", "metafile_path", "body"])
        body = _get(e["body"], bodies, "body", "DepthModel")
        model = DepthModel(e["name"], body, model_path="INFER",
                           metafile_path=_metafile(e, configfile_path))
        for b in _get_all(e.get("occlusion_bodies"), bodies, "occlusion_bodies",
                          "DepthModel"):
            model.AddOcclusionBody(b)
        depth_models.append(model)

    # Modalities
    modalities = []
    for e in _nodes(fs, "RegionModality"):
        _require(e, "RegionModality", ["name", "body", "color_camera", "region_model"])
        body = _get(e["body"], bodies, "body", "RegionModality")
        cam = _get(e["color_camera"], color_cameras, "color_camera", "RegionModality")
        model = _get(e["region_model"], region_models, "region_model", "RegionModality")
        modality = RegionModality(e["name"], body, cam, model,
                                  metafile_path=_metafile(e, configfile_path), device=device)
        if isinstance(e.get("measure_occlusions"), dict):
            modality.MeasureOcclusions(_get(
                e["measure_occlusions"]["depth_camera"], depth_cameras,
                "depth_camera", "RegionModality"))
        if isinstance(e.get("model_occlusions"), dict):
            modality.ModelOcclusions(_get(
                e["model_occlusions"]["focused_depth_renderer"], all_depth_renderers,
                "focused_depth_renderer", "RegionModality"))
        if isinstance(e.get("use_region_checking"), dict):
            modality.UseRegionChecking(_get(
                e["use_region_checking"]["focused_silhouette_renderer"],
                focused_silhouette_renderers, "focused_silhouette_renderer",
                "RegionModality"))
        if isinstance(e.get("use_shared_color_histograms"), dict):
            modality.UseSharedColorHistograms(_get(
                e["use_shared_color_histograms"]["color_histograms"], histograms,
                "color_histograms", "RegionModality"))
        modalities.append(modality)
    for e in _nodes(fs, "DepthModality"):
        _require(e, "DepthModality", ["name", "body", "depth_camera", "depth_model"])
        body = _get(e["body"], bodies, "body", "DepthModality")
        cam = _get(e["depth_camera"], depth_cameras, "depth_camera", "DepthModality")
        model = _get(e["depth_model"], depth_models, "depth_model", "DepthModality")
        modality = DepthModality(e["name"], body, cam, model,
                                 metafile_path=_metafile(e, configfile_path), device=device)
        if e.get("measure_occlusions") is not None:
            modality.MeasureOcclusions()
        if isinstance(e.get("model_occlusions"), dict):
            modality.ModelOcclusions(_get(
                e["model_occlusions"]["focused_depth_renderer"], all_depth_renderers,
                "focused_depth_renderer", "DepthModality"))
        if isinstance(e.get("use_silhouette_checking"), dict):
            modality.UseSilhouetteChecking(_get(
                e["use_silhouette_checking"]["focused_silhouette_renderer"],
                focused_silhouette_renderers, "focused_silhouette_renderer",
                "DepthModality"))
        modalities.append(modality)
    for e in _nodes(fs, "TextureModality"):
        _require(e, "TextureModality",
                 ["name", "body", "color_camera", "focused_silhouette_renderer"])
        body = _get(e["body"], bodies, "body", "TextureModality")
        cam = _get(e["color_camera"], color_cameras, "color_camera", "TextureModality")
        sil = _get(e["focused_silhouette_renderer"], focused_silhouette_renderers,
                   "focused_silhouette_renderer", "TextureModality")
        modality = TextureModality(e["name"], body, cam, sil,
                                   metafile_path=_metafile(e, configfile_path))
        if isinstance(e.get("measure_occlusions"), dict):
            modality.MeasureOcclusions(_get(
                e["measure_occlusions"]["depth_camera"], depth_cameras,
                "depth_camera", "TextureModality"))
        if isinstance(e.get("model_occlusions"), dict):
            modality.ModelOcclusions(_get(
                e["model_occlusions"]["focused_depth_renderer"], all_depth_renderers,
                "focused_depth_renderer", "TextureModality"))
        modalities.append(modality)

    # Links (two passes: construction, then child links)
    links = []
    for e in _nodes(fs, "Link"):
        _require(e, "Link", ["name"])
        link = Link(e["name"], metafile_path=_metafile(e, configfile_path))
        if e.get("body"):
            link.body_ptr = _get(e["body"], bodies, "body", "Link")
        for m in _get_all(e.get("modalities"), modalities, "modalities", "Link"):
            link.AddModality(m)
        links.append(link)
    for e in _nodes(fs, "Link"):
        link = _get(e["name"], links, "name", "Link")
        for child in _get_all(e.get("child_links"), links, "child_links", "Link"):
            link.AddChildLink(child)

    # Constraints
    constraints = []
    for e in _nodes(fs, "Constraint"):
        _require(e, "Constraint", ["name", "link1", "link2"])
        constraints.append(Constraint(
            e["name"], _get(e["link1"], links, "link1", "Constraint"),
            _get(e["link2"], links, "link2", "Constraint"),
            metafile_path=_metafile(e, configfile_path)))
    soft_constraints = []
    for e in _nodes(fs, "SoftConstraint"):
        _require(e, "SoftConstraint", ["name", "link1", "link2"])
        soft_constraints.append(SoftConstraint(
            e["name"], _get(e["link1"], links, "link1", "SoftConstraint"),
            _get(e["link2"], links, "link2", "SoftConstraint"),
            metafile_path=_metafile(e, configfile_path)))

    # Optimizers
    optimizers = []
    for e in _nodes(fs, "Optimizer"):
        _require(e, "Optimizer", ["name", "root_link"])
        optimizer = Optimizer(e["name"],
                              _get(e["root_link"], links, "root_link", "Optimizer"),
                              metafile_path=_metafile(e, configfile_path))
        for c in _get_all(e.get("constraints"), constraints, "constraints",
                          "Optimizer"):
            optimizer.AddConstraint(c)
        for c in _get_all(e.get("soft_constraints"), soft_constraints,
                          "soft_constraints", "Optimizer"):
            optimizer.AddSoftConstraint(c)
        optimizers.append(optimizer)

    # Viewers
    viewers = []
    for e in _nodes(fs, "ImageColorViewer"):
        _require(e, "ImageColorViewer", ["name", "color_camera"])
        viewers.append(ImageColorViewer(
            e["name"], _get(e["color_camera"], color_cameras, "color_camera",
                            "ImageColorViewer"),
            metafile_path=_metafile(e, configfile_path)))
    for e in _nodes(fs, "ImageDepthViewer"):
        _require(e, "ImageDepthViewer", ["name", "depth_camera"])
        viewers.append(ImageDepthViewer(
            e["name"], _get(e["depth_camera"], depth_cameras, "depth_camera",
                            "ImageDepthViewer"),
            metafile_path=_metafile(e, configfile_path)))
    for e in _nodes(fs, "NormalColorViewer"):
        _require(e, "NormalColorViewer", ["name", "color_camera", "renderer_geometry"])
        viewers.append(NormalColorViewer(
            e["name"], _get(e["color_camera"], color_cameras, "color_camera",
                            "NormalColorViewer"),
            _get(e["renderer_geometry"], renderer_geometries, "renderer_geometry",
                 "NormalColorViewer"),
            metafile_path=_metafile(e, configfile_path)))
    for e in _nodes(fs, "NormalDepthViewer"):
        _require(e, "NormalDepthViewer", ["name", "depth_camera", "renderer_geometry"])
        viewers.append(NormalDepthViewer(
            e["name"], _get(e["depth_camera"], depth_cameras, "depth_camera",
                            "NormalDepthViewer"),
            _get(e["renderer_geometry"], renderer_geometries, "renderer_geometry",
                 "NormalDepthViewer"),
            metafile_path=_metafile(e, configfile_path)))

    # Detectors
    detectors = []
    for e in _nodes(fs, "StaticDetector"):
        _require(e, "StaticDetector", ["name", "metafile_path", "optimizer"])
        detectors.append(StaticDetector(
            e["name"], _get(e["optimizer"], optimizers, "optimizer", "StaticDetector"),
            metafile_path=_metafile(e, configfile_path)))
    for e in _nodes(fs, "ManualDetector"):
        _require(e, "ManualDetector",
                 ["name", "metafile_path", "optimizer", "color_camera"])
        detectors.append(ManualDetector(
            e["name"], _get(e["optimizer"], optimizers, "optimizer", "ManualDetector"),
            _get(e["color_camera"], color_cameras, "color_camera", "ManualDetector"),
            metafile_path=_metafile(e, configfile_path)))

    # Refiners
    refiners = []
    for e in _nodes(fs, "Refiner"):
        _require(e, "Refiner", ["name", "optimizers"])
        refiner = Refiner(e["name"], metafile_path=_metafile(e, configfile_path))
        for o in _get_all(e["optimizers"], optimizers, "optimizers", "Refiner"):
            refiner.AddOptimizer(o)
        refiners.append(refiner)

    # Tracker
    tracker_nodes = _nodes(fs, "Tracker")
    if len(tracker_nodes) < 1:
        raise GeneratorError(f"No tracker was configured in {configfile_path}")
    if len(tracker_nodes) > 1:
        raise GeneratorError(
            f"More than one tracker was configured in {configfile_path}")
    e = tracker_nodes[0]
    _require(e, "Tracker", ["name", "optimizers"])
    tracker = Tracker(e["name"], metafile_path=_metafile(e, configfile_path))
    for o in _get_all(e["optimizers"], optimizers, "optimizers", "Tracker"):
        tracker.AddOptimizer(o)
    for d in _get_all(e.get("detectors"), detectors, "detectors", "Tracker"):
        tracker.AddDetector(d)
    for r in _get_all(e.get("refiners"), refiners, "refiners", "Tracker"):
        tracker.AddRefiner(r)
    for v in _get_all(e.get("viewers"), viewers, "viewers", "Tracker"):
        tracker.AddViewer(v)
    return tracker
