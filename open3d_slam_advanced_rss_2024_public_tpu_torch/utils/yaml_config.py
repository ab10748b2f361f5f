"""Legacy YAML parameter loader (a copy of the JAX package's
``utils/yaml_config.py``, which the port may not import).

Equivalent of the reference's legacy YAML tier
(reference: open3d_slam_rsl/open3d_slam/open3d_slam_io/legacy/
open3d_slam_yaml_io/src/parameter_loaders.cpp — the pre-Lua schema with
top-level sections ``mapping`` / ``visualization`` / ``saving_parameters``
/ ``motion_compensation`` / ``odometry`` and the legacy spellings:
``mapping.scan_to_map_refinement`` with nested ``icp_parameters``,
``submaps.size``/``max_num_points``, per-section ``scan_processing``).

The loader translates the legacy keys into the modern
:func:`utils.config.load_parameters` override tree, so one config system
backs both tiers (Lua inherits the same property).  Unknown keys raise —
the same strictness the Lua tier enforces (LuaLoader.cpp:96-130); the
legacy C++ loader merely warned, but silent typos are how configs rot.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .config import SlamParameters, load_parameters

def _take(node: dict, key: str, default=None):
    return node.pop(key) if key in node else default


def _set(out: dict, path: str, value) -> None:
    if value is None:
        return
    cur = out
    parts = path.split(".")
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def _err_unknown(section: str, node: dict) -> None:
    if node:
        raise ValueError(f"unknown legacy YAML keys in {section!r}: "
                         f"{sorted(node)}")


def _scan_cropping(node: Optional[dict], out: dict, prefix: str) -> None:
    if node is None:
        return
    node = dict(node)
    for k in ("cropping_radius_max", "cropping_radius_min", "min_z", "max_z",
              "cropper_type"):
        _set(out, f"{prefix}.{k}", _take(node, k))
    _err_unknown("scan_cropping", node)


def _scan_processing(node: Optional[dict], out: dict, prefix: str) -> None:
    if node is None:
        return
    node = dict(node)
    for k in ("voxel_size", "downsampling_ratio", "point_cloud_buffer_size",
              "point_capacity"):
        _set(out, f"{prefix}.{k}", _take(node, k))
    _scan_cropping(_take(node, "scan_cropping"), out, f"{prefix}.scan_cropping")
    _err_unknown("scan_processing", node)


def _icp(node: Optional[dict], out: dict, prefix: str) -> None:
    if node is None:
        return
    node = dict(node)
    for k in ("knn", "max_correspondence_dist", "max_n_iter",
              "max_distance_knn", "reference_cloud_seting_period"):
        v = _take(node, k)
        if k == "reference_cloud_seting_period":
            continue  # legacy misspelling; subsumed by per-scan re-crop
        _set(out, f"{prefix}.{k}", v)
    _err_unknown("icp_parameters", node)


def _space_carving(node: Optional[dict], out: dict, prefix: str) -> None:
    if node is None:
        return
    node = dict(node)
    for k in ("voxel_size", "neigborhood_radius_for_removal",
              "max_raytracing_length", "truncation_distance",
              "carve_space_every_n_scans", "min_dot_product_with_normal"):
        _set(out, f"{prefix}.{k}", _take(node, k))
    _err_unknown("space_carving", node)


def _map_builder(node: Optional[dict], out: dict, prefix: str) -> None:
    if node is None:
        return
    node = dict(node)
    _set(out, f"{prefix}.map_voxel_size", _take(node, "map_voxel_size"))
    _space_carving(_take(node, "space_carving"), out, f"{prefix}.space_carving")
    _scan_cropping(_take(node, "scan_cropping"), out, f"{prefix}.scan_cropping")
    _err_unknown("map_builder", node)


def _place_recognition(node: Optional[dict], out: dict) -> None:
    if node is None:
        return
    node = dict(node)
    p = "mapper.place_recognition"
    direct = ("feature_map_normal_estimation_radius", "feature_voxel_size",
              "feature_radius", "feature_knn", "feature_normal_knn",
              "ransac_num_iter", "ransac_probability", "ransac_model_size",
              "ransac_max_correspondence_dist",
              "ransac_correspondence_checker_distance",
              "ransac_correspondence_checker_edge_length",
              "ransac_min_corresondence_set_size",
              "dump_aligned_place_recognitions_to_file",
              "min_submaps_between_loop_closures")
    for k in direct:
        _set(out, f"{p}.{k}", _take(node, k))
    # Legacy renames (parameter_loaders.cpp:71-75).
    _set(out, f"{p}.max_icp_correspondence_distance",
         _take(node, "max_icp_correspondence_distance"))
    _set(out, f"{p}.min_icp_refinement_fitness",
         _take(node, "min_icp_refinement_fitness"))
    _set(out, f"{p}.loop_closure_search_radius",
         _take(node, "loop_closure_serach_radius"))  # (sic) legacy spelling
    cc = _take(node, "consistency_check")
    if cc is not None:
        cc = dict(cc)
        for k in ("max_drift_roll", "max_drift_pitch", "max_drift_yaw"):
            v = _take(cc, k)
            if v is not None:
                # Legacy stores degrees and converts on load
                # (parameter_loaders.cpp:50-52); our schema keeps degrees.
                _set(out, f"{p}.consistency_check.{k}", v)
        for k in ("max_drift_x", "max_drift_y", "max_drift_z"):
            _set(out, f"{p}.consistency_check.{k}", _take(cc, k))
        _err_unknown("consistency_check", cc)
    _err_unknown("place_recognition", node)


def _submaps(node: Optional[dict], out: dict) -> None:
    if node is None:
        return
    node = dict(node)
    p = "mapper.submaps"
    _set(out, f"{p}.submap_size", _take(node, "size"))  # legacy name
    _set(out, f"{p}.max_num_points", _take(node, "max_num_points"))
    for k in ("min_num_range_data", "adjacency_based_revisiting_min_fitness",
              "min_seconds_between_feature_computation",
              "submaps_num_scan_overlap"):
        _set(out, f"{p}.{k}", _take(node, k))
    _err_unknown("submaps", node)


def _mapping(node: Optional[dict], out: dict) -> None:
    if node is None:
        return
    node = dict(node)
    ml = "mapper.mapper_localizer"
    for k in ("is_build_dense_map", "is_attempt_loop_closures",
              "min_movement_between_mapping_steps",
              "ignore_minimum_refinement_fitness",
              "dump_submaps_to_file_before_after_lc",
              "is_print_timing_information",
              "is_refine_odometry_constraints_between_submaps",
              "is_use_map_initialization", "republish_the_preloaded_map",
              "map_merge_delay_in_seconds", "is_carving_enabled",
              "is_merge_scans_into_map", "mapping_buffer_size"):
        _set(out, f"{ml}.{k}", _take(node, k))
    s2m = _take(node, "scan_to_map_refinement")
    if s2m is not None:
        s2m = dict(s2m)
        reg = f"{ml}.scan_to_map_registration"
        _set(out, f"{reg}.scan_to_map_refinement_type",
             _take(s2m, "scan_to_map_refinement_type"))
        _set(out, f"{reg}.min_refinement_fitness",
             _take(s2m, "min_refinement_fitness"))
        _icp(_take(s2m, "icp_parameters"), out, f"{reg}.icp")
        _scan_processing(_take(s2m, "scan_processing"), out,
                         f"{reg}.scan_processing")
        _err_unknown("scan_to_map_refinement", s2m)
    _map_builder(_take(node, "map_builder"), out, "mapper.map_builder")
    _map_builder(_take(node, "dense_map_builder"), out,
                 "mapper.dense_map_builder")
    _submaps(_take(node, "submaps"), out)
    go = _take(node, "global_optimization")
    if go is not None:
        go = dict(go)
        for k in ("edge_prune_threshold", "loop_closure_preference",
                  "max_correspondence_distance", "reference_node"):
            _set(out, f"mapper.global_optimization.{k}", _take(go, k))
        _err_unknown("global_optimization", go)
    _place_recognition(_take(node, "place_recognition"), out)
    mi = _take(node, "map_intializer")  # (sic) legacy spelling
    if mi is not None:
        mi = dict(mi)
        for k in ("is_initialize_interactively", "frame_id", "pcd_file_path",
                  "init_pose"):
            _set(out, f"mapper.map_initializer.{k}", _take(mi, k))
        _err_unknown("map_intializer", mi)
    _err_unknown("mapping", node)


def _odometry(node: Optional[dict], out: dict) -> None:
    if node is None:
        return
    node = dict(node)
    for k in ("is_publish_odometry_msgs",
              "use_odometry_topic_instead_of_scan_to_scan",
              "use_IMU_for_attitude_initialization", "odometry_buffer_size"):
        _set(out, f"odometry.{k}", _take(node, k))
    sm = _take(node, "scan_matching")
    if sm is not None:
        sm = dict(sm)
        _set(out, "odometry.scan_matching.cloud_registration_type",
             _take(sm, "cloud_registration_type"))
        _icp(_take(sm, "icp_parameters"), out, "odometry.scan_matching.icp")
        _err_unknown("scan_matching", sm)
    _scan_processing(_take(node, "scan_processing"), out,
                     "odometry.scan_processing")
    _err_unknown("odometry", node)


def overrides_from_legacy_yaml(doc: Dict[str, Any]) -> dict:
    """Translate a parsed legacy YAML document into the modern override
    tree (strict: unknown keys raise)."""
    doc = dict(doc or {})
    out: dict = {}
    _mapping(_take(doc, "mapping"), out)
    _odometry(_take(doc, "odometry"), out)
    vis = _take(doc, "visualization")
    if vis is not None:
        vis = dict(vis)
        for k in ("assembled_map_voxel_size", "submaps_voxel_size",
                  "visualize_every_n_msec"):
            _set(out, f"visualization.{k}", _take(vis, k))
        _err_unknown("visualization", vis)
    sav = _take(doc, "saving_parameters")
    if sav is not None:
        sav = dict(sav)
        for k in ("save_at_mission_end", "save_map", "save_submaps",
                  "save_dense_submaps"):
            _set(out, f"saving.{k}", _take(sav, k))
        _err_unknown("saving_parameters", sav)
    mc = _take(doc, "motion_compensation")
    if mc is not None:
        mc = dict(mc)
        for k in ("is_undistort_scan", "is_spinning_clockwise",
                  "scan_duration", "num_poses_vel_estimation"):
            _set(out, f"motion_compensation.{k}", _take(mc, k))
        _err_unknown("motion_compensation", mc)
    _err_unknown("<root>", doc)
    return out


def load_legacy_yaml(path: str) -> SlamParameters:
    """≙ io_yaml::loadParameters (legacy parameter_loaders.cpp:203-230)."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    return load_parameters(overrides_from_legacy_yaml(doc))
