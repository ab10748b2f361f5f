"""Config-driven ICP chain construction — the module-registry analogue.

Counterpart of the JAX package's ``ops/registration/chain.py`` (reference
pointmatcher/Registrar.h, Registry.cpp:59-131, ICP.cpp:113-160
``ICPChainBase::loadFromYaml``, and the standalone filter pipeline runner
PointMatcherFilterInterface.h:12-22).  A chain file has the schema and the
module names of the reference's ``icp.yaml``
(ros/open3d_slam_ros/param/icp.yaml):

    readingDataPointsFilters:
      - RandomSamplingDataPointsFilter:
          prob: 0.5
    referenceDataPointsFilters:
      - SurfaceNormalDataPointsFilter:
          knn: 10
    matcher:
      KDTreeMatcher:
        knn: 1
        maxDist: 0.5
    outlierFilters:
      - TrimmedDistOutlierFilter:
          ratio: 0.90
    errorMinimizer:
      PointToPlaneErrorMinimizer
    transformationCheckers:
      - CounterTransformationChecker:
          maxIterationCount: 15
      - DifferentialTransformationChecker:
          minDiffRotErr: 0.001
          minDiffTransErr: 0.01
          smoothLength: 3

so a user of the reference loads a tuned chain unchanged.  Loading gives
two filter pipelines and an :class:`ICPConfig` for :func:`icp.register`.

Differences from the JAX package, each on purpose:
  - the default matcher is ``"auto"``: kernel K1 on CUDA tensors, its plain
    twin on the CPU (JAX: ``"bruteforce"``); for the kernel matcher the
    filtered reading and reference go to K1 in Morton order, so that its
    tiles stay compact (the registration is the same up to the order of
    floating-point sums and exact distance ties);
  - random filters draw from host generators seeded per filter
    (``filters.fold_in(seed, i)``, the role of ``jax.random.fold_in``); a
    ``FilterPipeline`` and the reading side of ``register`` also take the
    draws from a caller (``rand(i, n)``), as the tests feed JAX's;
  - ``register`` polls the loop's done flag every ``icp.POLL_EVERY`` trips
    and stops dispatching at convergence (same result, fewer launches).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ...utils.device import to_device
from ...utils.pointcloud import PointCloud
from .. import filters, filters_extra, hashgrid, normals
from . import icp, loggers, parametrizable
from .icp import ICPConfig

Tensor = torch.Tensor
# rand(i, n) -> f32[n] uniforms for filter i of a pipeline (None: seeded draws).
Rand = Optional[Callable[[int, int], Tensor]]


def _canon(name: str) -> str:
    """Canonical registry name: the class suffix stripped, lower case
    (``RandomSamplingDataPointsFilter`` -> ``randomsampling``)."""
    for suffix in ("DataPointsFilter", "OutlierFilter", "ErrorMinimizer",
                   "TransformationChecker", "Matcher", "Inspector", "Logger"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
            break
    return name.strip().lower()


def _entries(section) -> List[Tuple[str, Dict[str, Any]]]:
    """A YAML section as [(name, params)]: a list of {Name: {params}} or bare
    names, or a single mapping or bare name (errorMinimizer, matcher)."""
    if section is None:
        return []
    out: List[Tuple[str, Dict[str, Any]]] = []
    for item in section if isinstance(section, list) else [section]:
        if isinstance(item, str):
            out.append((item, {}))
        elif isinstance(item, dict):
            for k, v in item.items():
                out.append((k, dict(v) if isinstance(v, dict) else {}))
        else:
            raise ValueError(f"unparseable chain entry: {item!r}")
    return out


# --------------------------------------------------------------------------
# DataPointsFilter registry: canonical name -> fn(cloud, draw, params), where
# draw(n) gives the filter's n uniforms.  Parameter names and defaults follow
# the libpointmatcher modules (DataPointsFilters/*.cpp declareParameter).
# --------------------------------------------------------------------------

def _f_distance_limit(cloud, draw, p):
    # dim: 0/1/2 = axis threshold, -1 = radial (reference DistanceLimit).
    dim, dist = int(p.get("dim", -1)), float(p.get("dist", 1.0))
    remove_inside = int(p.get("removeInside", 0))
    if dim < 0:
        if remove_inside:
            return filters.distance_limit(cloud, min_dist=dist)
        return filters.distance_limit(cloud, max_dist=dist)
    lo, hi = [-math.inf] * 3, [math.inf] * 3
    lo[dim], hi[dim] = -dist, dist
    return filters.bounding_box(cloud, lo, hi, invert=bool(remove_inside))


def _f_bounding_box(cloud, draw, p):
    lo = [float(p.get(k, -1.0)) for k in ("xMin", "yMin", "zMin")]
    hi = [float(p.get(k, 1.0)) for k in ("xMax", "yMax", "zMax")]
    return filters.bounding_box(cloud, lo, hi, invert=bool(int(p.get("removeInside", 1))))


def _f_sensor_noise(cloud, draw, p):
    # sensorType codes (reference SimpleSensorNoise.cpp): 0 = LMS, 1 = HDL, ...
    st = p.get("sensorType", "lms")
    st = {0: "lms", 1: "hdl"}.get(int(st), "other") if str(st).isdigit() else str(st)
    return filters_extra.with_simple_sensor_noise(cloud, sensor_type=st,
                                                  gain=float(p.get("gain", 1.0)))


def _f_organized_surface_normal(cloud, draw, p):
    # The reference reads the image shape off DataPoints' IndexGrid, which a
    # fixed-shape cloud lacks: the chain file gives it.
    if "rows" not in p or "cols" not in p:
        raise ValueError(
            "OrganizedCloudSurfaceNormalDataPointsFilter needs explicit 'rows' and 'cols' "
            "(the range-image shape; the reference reads them from DataPoints::IndexGrid, "
            "which fixed-shape clouds lack)")
    return normals.organized_surface_normals(cloud, rows=int(p["rows"]), cols=int(p["cols"]),
                                             knn=int(p.get("knn", 5)),
                                             max_dist=float(p.get("maxDist", math.inf)))


def _flag(p, name, default):
    return bool(int(p.get(name, default)))


def _f_elipsoids(cloud, draw, p):
    return filters_extra.elipsoids(
        cloud, draw(cloud.capacity), ratio=float(p.get("ratio", 0.5)),
        knn=int(p.get("knn", 7)), sampling_method=int(p.get("samplingMethod", 0)),
        max_box_dim=float(p.get("maxBoxDim", math.inf)),
        min_planarity=float(p.get("minPlanarity", 0.0)),
        keep_normals=_flag(p, "keepNormals", 1), keep_densities=_flag(p, "keepDensities", 0),
        keep_eigen_values=_flag(p, "keepEigenValues", 0),
        keep_eigen_vectors=_flag(p, "keepEigenVectors", 0),
        keep_covariances=_flag(p, "keepCovariances", 0),
        keep_weights=_flag(p, "keepWeights", 0), keep_means=_flag(p, "keepMeans", 0),
        keep_shapes=_flag(p, "keepShapes", 0),
        average_existing_descriptors=_flag(p, "averageExistingDescriptors", 1))


def _f_gestalt(cloud, draw, p):
    return filters_extra.gestalt(
        cloud, draw(cloud.capacity), ratio=float(p.get("ratio", 0.1)),
        radius=float(p.get("radius", 5.0)), knn=int(p.get("knn", 7)),
        vsize=tuple(float(p.get(k, 1.0)) for k in ("vSizeX", "vSizeY", "vSizeZ")),
        keep_normals=_flag(p, "keepNormals", 1), keep_means=_flag(p, "keepMeans", 0),
        keep_eigen_values=_flag(p, "keepEigenValues", 0),
        keep_eigen_vectors=_flag(p, "keepEigenVectors", 0),
        keep_covariances=_flag(p, "keepCovariances", 0),
        keep_gestalt_features=_flag(p, "keepGestaltFeatures", 1),
        average_existing_descriptors=_flag(p, "averageExistingDescriptors", 1))


_FILTERS = {
    "identity": lambda c, d, p: c,
    "removenan": lambda c, d, p: filters.remove_non_finite(c),
    "maxdist": lambda c, d, p: filters.distance_limit(c, max_dist=float(p.get("maxDist", 1.0))),
    "mindist": lambda c, d, p: filters.distance_limit(c, min_dist=float(p.get("minDist", 1.0))),
    "distancelimit": _f_distance_limit,
    "boundingbox": _f_bounding_box,
    "maxquantileonaxis": lambda c, d, p: filters_extra.max_quantile_on_axis(
        c, ratio=float(p.get("ratio", 0.5)), axis=int(p.get("dim", 0))),
    "maxdensity": lambda c, d, p: filters_extra.max_density(
        c, d(c.capacity), max_density_pts_per_m3=float(p.get("maxDensity", 10.0))),
    "surfacenormal": lambda c, d, p: normals.estimate_normals(
        c, radius=float(p.get("radius", 1.0)), k=int(p.get("knn", 10))),
    "samplingsurfacenormal": lambda c, d, p: filters_extra.sampling_surface_normal(
        c, d(c.capacity), ratio=float(p.get("ratio", 0.5)), knn=int(p.get("knn", 7))),
    "orientnormals": lambda c, d, p: filters_extra.orient_normals(
        c, toward_sensor=_flag(p, "towardCenter", 1)),
    # The sensor -> point direction descriptor (consumed by OrientNormals);
    # the geometry is unchanged.
    "observationdirection": lambda c, d, p: filters_extra.with_observation_direction(
        c, sensor=tuple(float(p.get(k, 0.0)) for k in ("x", "y", "z"))),
    "incidenceangle": lambda c, d, p: filters_extra.with_incidence_angle(c),
    "randomsampling": lambda c, d, p: filters.random_sampling(
        c, d(c.capacity), prob=float(p.get("prob", 0.75))),
    "maxpointcount": lambda c, d, p: filters.max_point_count(
        c, d(c.capacity), int(p.get("maxCount", 1000000))),
    "fixstepsampling": lambda c, d, p: filters_extra.fix_step_sampling(
        c, step=int(p.get("startStep", 10))),
    "shadow": lambda c, d, p: filters_extra.shadow_filter(c, eps=float(p.get("eps", 0.1))),
    "simplesensornoise": _f_sensor_noise,
    "voxelgrid": lambda c, d, p: filters.voxel_downsample(
        c, float(p.get("vSizeX", 0.2)), c.capacity, order="lex"),
    "normalspace": lambda c, d, p: filters_extra.normal_space_sampling(
        c, d(c.capacity), target=int(p.get("nbSample", 5000))),
    "covariancesampling": lambda c, d, p: filters_extra.covariance_sampling(
        c, target=int(p.get("nbSample", 5000))),
    "octreegrid": lambda c, d, p: filters_extra.octree_grid(
        c, max_size_by_node=float(p.get("maxSizeByNode", 0.2)),
        sample_mode=int(p.get("samplingMethod", 0))),
    "hiddenpointremoval": lambda c, d, p: filters_extra.hidden_point_removal(
        c, radius_scale=float(p.get("radius", 100.0))),
    "cutatdescriptorthreshold": lambda c, d, p: filters_extra.cut_at_descriptor_threshold(
        c, descriptor=str(p.get("descName", "incidenceAngles")),
        threshold=float(p.get("threshold", 0.5)),
        use_larger_than=_flag(p, "useLargerThan", 1)),
    "removesensorbias": lambda c, d, p: filters_extra.remove_sensor_bias(
        c, angle_threshold=float(p.get("angleThreshold", 0.785))),
    "organizedcloudsurfacenormal": _f_organized_surface_normal,
    "elipsoids": _f_elipsoids,
    "gestalt": _f_gestalt,
}


class FilterPipeline:
    """An ordered DataPointsFilter pipeline over fixed-capacity clouds
    (≙ readingDataPointsFilters / referenceDataPointsFilters applied in
    sequence, ICP.cpp:300-345, and PointMatcherFilterInterface::process)."""

    def __init__(self, specs: Sequence[Tuple[str, Dict[str, Any]]]):
        self.specs = []
        for raw_name, params in specs:
            name = _canon(raw_name)
            if name not in _FILTERS:
                raise ValueError(f"unknown DataPointsFilter {raw_name!r} (canonical {name!r}); "
                                 f"known: {sorted(_FILTERS)}")
            # Per-parameter bounds (≙ Parametrizable.cpp InvalidParameter).
            parametrizable.validate("dataPointsFilter", name, params)
            self.specs.append((name, dict(params)))

    def __call__(self, cloud: PointCloud, seed: int = 0, rand: Rand = None) -> PointCloud:
        """Apply the filters in order.  Filter i draws its uniforms from a
        host generator seeded with ``filters.fold_in(seed, i)``, or takes
        ``rand(i, n)`` when given."""
        for i, (name, params) in enumerate(self.specs):
            def draw(n, i=i, dev=cloud.device):
                if rand is not None:
                    return to_device(rand(i, n), dev)
                return filters.uniform(filters.fold_in(seed, i), n, dev)
            cloud = _FILTERS[name](cloud, draw, params)
        return cloud


# --------------------------------------------------------------------------
# Chain assembly
# --------------------------------------------------------------------------

_OUTLIER_MAP = {
    "null": lambda p: ("null",),
    "trimmeddist": lambda p: ("trimmed", float(p.get("ratio", 0.85))),
    "vartrimmeddist": lambda p: ("var_trimmed", float(p.get("minRatio", 0.05)),
                                 float(p.get("maxRatio", 0.99)), float(p.get("lambda", 2.35))),
    "mediandist": lambda p: ("median", float(p.get("factor", 3.0))),
    "maxdist": lambda p: ("max_dist", float(p.get("maxDist", 1.0))),
    "mindist": lambda p: ("min_dist", float(p.get("minDist", 0.1))),
    "surfacenormal": lambda p: ("surface_normal", float(p.get("maxAngle", 1.57))),
    # (fct, tuning, scaleEstimator, distanceType, approximation): the
    # RobustOutlierFilter parameters (OutlierFiltersImpl.cpp:390-436).
    "robust": lambda p: ("robust", str(p.get("robustFct", "cauchy")),
                         float(p.get("tuning", 1.0)), str(p.get("scaleEstimator", "none")),
                         str(p.get("distanceType", "point2point")),
                         float(p.get("approximation", float("inf")))),
    # (soft, larger, threshold); descName is the reference grid's channel
    # (OutlierFiltersImpl.h:196-221 reads the REFERENCE cloud's descriptor
    # for either 'source' setting).
    "genericdescriptor": lambda p: ("generic_desc", _flag(p, "useSoftThreshold", 0),
                                    _flag(p, "useLargerThan", 1),
                                    float(p.get("threshold", 0.1))),
}

_MINIMIZER_MAP = {
    "identity": ("identity", False),
    "pointtopoint": ("point_to_point", False),
    "pointtopointsimilarity": ("similarity", False),
    "pointtoplane": ("point_to_plane", False),
    "pointtopointwithcov": ("point_to_point", True),
    "pointtoplanewithcov": ("point_to_plane", True),
}


def kernel_order(cloud: PointCloud, cfg: ICPConfig) -> PointCloud:
    """The cloud in Morton order when K1 matches it (compact tiles), else
    as it is."""
    if cfg.matcher in icp.KERNEL_MATCHERS and cfg.knn == 1:
        d = cfg.max_correspondence_dist
        return hashgrid.morton_sort(cloud, d if math.isfinite(d) else 1.0)
    return cloud


def reference_grid(cloud: PointCloud, cfg: ICPConfig, desc_channel: Optional[str] = None,
                   table_size: int = 1 << 14) -> hashgrid.HashGrid:
    """The matcher's reference: the hashed grid for ``matcher="hashgrid"``
    (cells of maxDist), else the cloud as it is, in Morton order for K1
    (the dense matchers read only points, normals and the descriptor)."""
    d = cfg.max_correspondence_dist
    if cfg.matcher == "hashgrid" and math.isfinite(d):
        return hashgrid.build(cloud, d, table_size=table_size, desc_channel=desc_channel)
    return hashgrid.passthrough(kernel_order(cloud, cfg), 1.0, desc_channel=desc_channel)


@dataclasses.dataclass
class IcpChain:
    """A fully assembled registration chain (≙ a configured PM::ICP):
    reading and reference filter pipelines and an :class:`ICPConfig`;
    ``with_covariance`` marks a *WithCov minimizer (``register`` then
    returns the solution covariance too)."""

    reading_filters: FilterPipeline
    reference_filters: FilterPipeline
    config: ICPConfig
    with_covariance: bool = False
    sensor_std: float = 0.01
    # The reference channel that GenericDescriptorOutlierFilter reads.
    ref_desc_channel: Optional[str] = None
    # The chain logger (the yaml ``logger`` section, Registry.cpp:126-127).
    logger: loggers.Logger = dataclasses.field(default_factory=loggers.NullLogger)

    def process_reading(self, cloud: PointCloud, seed: int = 0) -> PointCloud:
        return self.reading_filters(cloud, seed)

    def process_reference(self, cloud: PointCloud, seed: int = 0) -> PointCloud:
        return self.reference_filters(cloud, seed)

    def register(self, source: PointCloud, reference: Union[PointCloud, hashgrid.HashGrid],
                 init_T, seed: int = 0, table_size: int = 1 << 14,
                 rand_reading: Rand = None):
        """Filter both clouds, build the reference, run the ICP loop
        (≙ PM::ICP::operator()(reading, reference, initial), ICP.cpp:231-256).
        A prebuilt HashGrid as ``reference`` skips the reference filters.
        The reading filters draw from ``fold_in(seed, 0)``, or take
        ``rand_reading(i, n)`` when given; the reference filters draw from
        ``fold_in(seed, 1)``."""
        src = kernel_order(self.reading_filters(source, filters.fold_in(seed, 0), rand_reading),
                           self.config)
        if isinstance(reference, PointCloud):
            ref = self.process_reference(reference, filters.fold_in(seed, 1))
            grid = reference_grid(ref, self.config, self.ref_desc_channel, table_size)
        else:
            grid = reference
        T0 = to_device(init_T, src.device)
        if self.with_covariance:
            res = icp.register_with_covariance(src, grid, T0, self.config,
                                               sensor_std=self.sensor_std,
                                               poll_every=icp.POLL_EVERY)
        else:
            res = icp.register(src, grid, T0, self.config, poll_every=icp.POLL_EVERY)
        if self.logger.has_info:
            # One summary a call, read back (the loop's trips never wait).
            r = res[0] if isinstance(res, tuple) else res
            t = r.transform[:3, 3].tolist()
            self.logger.info(
                f"PointMatcher::icp - reading {int(src.count())} pts, "
                f"{int(r.iterations)} iterations, match ratio "
                f"{float(r.match_ratio):.4f}, translation "
                f"[{t[0]:.4f} {t[1]:.4f} {t[2]:.4f}]")
        return res


def from_dict(chain: Dict[str, Any], matcher_impl: str = "auto") -> IcpChain:
    """Assemble an :class:`IcpChain` from a parsed chain dict (≙
    ICPChainBase::loadFromYaml, ICP.cpp:113-160): every module resolved by
    its registry name, unknown sections and modules rejected."""
    known = {"readingDataPointsFilters", "readingStepDataPointsFilters",
             "referenceDataPointsFilters", "matcher", "outlierFilters",
             "errorMinimizer", "transformationCheckers", "inspector", "logger"}
    unknown = set(chain) - known
    if unknown:
        raise ValueError(f"unknown ICP chain sections: {sorted(unknown)}")
    reading = FilterPipeline(_entries(chain.get("readingDataPointsFilters")))
    reference = FilterPipeline(_entries(chain.get("referenceDataPointsFilters")))
    cfg_kw: Dict[str, Any] = {"matcher": icp.resolve_matcher(matcher_impl)}

    m = _entries(chain.get("matcher"))
    if m:
        name, params = m[0]
        cname = _canon(name)
        if cname not in ("kdtree", "kdtreevardist", "null", "bruteforce"):
            raise ValueError(f"unknown matcher {name!r}")
        parametrizable.validate("matcher", cname, params)
        # KDTreeMatcher defaults (MatchersImpl.h): knn 1, maxDist inf; knn > 1
        # stacks every match as a correspondence; the search is exact.
        cfg_kw["max_correspondence_dist"] = float(params.get("maxDist", float("inf")))
        cfg_kw["knn"] = int(params.get("knn", 1))
        if cname == "kdtreevardist":
            # The per-reading-point radius from a descriptor channel
            # (KDTreeVarDistMatcher, MatchersImpl.h:119-148).
            cfg_kw["max_dist_field"] = str(params.get("maxDistField", "maxSearchDist"))

    ref_desc_channel = None
    ofs = _entries(chain.get("outlierFilters"))
    if ofs:
        entries = []
        for name, params in ofs:
            cname = _canon(name)
            if cname not in _OUTLIER_MAP:
                raise ValueError(f"unknown outlier filter {name!r}; "
                                 f"known: {sorted(_OUTLIER_MAP)}")
            parametrizable.validate("outlierFilter", cname, params)
            if cname == "genericdescriptor":
                ref_desc_channel = str(params.get("descName", "none"))
            entries.append(_OUTLIER_MAP[cname](params))
        cfg_kw["outlier_chain"] = tuple(entries)

    with_cov, sensor_std = False, 0.01
    em = _entries(chain.get("errorMinimizer"))
    if em:
        name, params = em[0]
        cname = _canon(name)
        if cname not in _MINIMIZER_MAP:
            raise ValueError(f"unknown error minimizer {name!r}; "
                             f"known: {sorted(_MINIMIZER_MAP)}")
        cfg_kw["minimizer"], with_cov = _MINIMIZER_MAP[cname]
        sensor_std = float(params.get("sensorStdDev", 0.01))
        # PointToPlane DOF restrictions (PointToPlane.cpp:87-106).
        if int(params.get("force4DOF", 0)):
            cfg_kw["force4dof"] = True
        if int(params.get("force2D", 0)):
            cfg_kw["force2d"] = True

    for name, params in _entries(chain.get("transformationCheckers")):
        cname = _canon(name)
        parametrizable.validate("transformationChecker", cname, params)
        if cname == "counter":
            cfg_kw["max_iterations"] = int(params.get("maxIterationCount", 40))
        elif cname == "differential":
            cfg_kw["min_diff_rot"] = float(params.get("minDiffRotErr", 0.001))
            cfg_kw["min_diff_trans"] = float(params.get("minDiffTransErr", 0.001))
            cfg_kw["smooth_length"] = int(params.get("smoothLength", 3))
        elif cname == "bound":
            cfg_kw["bound_max_rot"] = float(params.get("maxRotationNorm", 1.0))
            cfg_kw["bound_max_trans"] = float(params.get("maxTranslationNorm", 1.0))
        else:
            raise ValueError(f"unknown transformation checker {name!r}")

    # The inspector section stays configuration-compatible; per-iteration
    # dumps run through inspectors.py.
    logger = loggers.NullLogger()
    lg = _entries(chain.get("logger"))
    if lg:
        logger = loggers.make_logger(*lg[0])
    return IcpChain(reading_filters=reading, reference_filters=reference,
                    config=ICPConfig(**cfg_kw),
                    with_covariance=with_cov, sensor_std=sensor_std,
                    ref_desc_channel=ref_desc_channel, logger=logger)


def _load_yaml(path: str):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def from_yaml(path: str, matcher_impl: str = "auto") -> IcpChain:
    """Load an icp.yaml chain file (the schema of the reference's
    ros/open3d_slam_ros/param/icp.yaml)."""
    return from_dict(_load_yaml(path) or {}, matcher_impl=matcher_impl)


def filter_pipeline_from_yaml(path: str) -> FilterPipeline:
    """A standalone filter pipeline from a YAML list of DataPointsFilters
    (≙ PointMatcherFilterInterface::readPipelineFile)."""
    return FilterPipeline(_entries(_load_yaml(path)))
