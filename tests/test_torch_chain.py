"""The libpointmatcher ICP chain of the port against the JAX package (CPU):
``chain.from_yaml``/``from_dict``, ``IcpChain.register``, ``ICPSequence``,
the inspectors, the loggers and the parameter bounds.

Every registration runs the same numpy scene through both packages: the
JAX chain on its default brute-force matcher, the port's on its default
"auto" matcher (kernel K1's plain twin on the CPU); the random reading
filter of the production chain runs on JAX's own draws.  Held: the
transforms within 1e-4 m and 1e-4 rad, the iteration counts equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from open3d_slam_advanced_rss_2024_public_tpu.ops import generators as jgen
from open3d_slam_advanced_rss_2024_public_tpu.ops import normals as jnormals
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import chain as jchain
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import inspectors as jinspectors
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import loggers as jloggers
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import parametrizable as jparam
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import sequence as jsequence
from open3d_slam_advanced_rss_2024_public_tpu.utils import se3 as jse3
from open3d_slam_advanced_rss_2024_public_tpu.utils.pointcloud import make_cloud as jmake
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import hashgrid
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import (
    chain, inspectors, loggers, parametrizable, sequence)
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import convert
from test_chain import PRODUCTION_CHAIN
from test_torch_filters_extra import jax_draws

TOL = 1e-4
T_TRUE = np.asarray(jse3.make_transform(jse3.so3_exp(jnp.asarray([0.01, -0.005, 0.02])),
                                        jnp.asarray([0.08, -0.05, 0.03])))


def _gap(a, b):
    """(translation m, rotation rad) between two 4 x 4 transforms."""
    d = np.linalg.inv(np.asarray(a, np.float64)) @ np.asarray(b, np.float64)
    R = d[:3, :3]
    sin = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    # atan2 of the skew and symmetric parts: arccos of the trace alone
    # amplifies the float32 rounding of near-identity rotations.
    return float(np.linalg.norm(d[:3, 3])), float(np.arctan2(sin, (np.trace(R) - 1.0) / 2.0))


def _assert_same(jres, tres):
    jr = jres[0] if isinstance(jres, tuple) else jres
    tr = tres[0] if isinstance(tres, tuple) else tres
    dt, da = _gap(jr.transform, tr.transform.numpy())
    assert dt < TOL and da < TOL, (dt, da)
    assert int(jr.iterations) == int(tr.iterations)
    assert bool(jr.diverged) == bool(tr.diverged)
    np.testing.assert_allclose(float(tr.match_ratio), float(jr.match_ratio), atol=1e-3)


@pytest.fixture(scope="module")
def room():
    """(reference, reading) of 2048 points, both packages: a noisy room scan
    and the same scan with its normals moved by the inverse of T_TRUE (as
    ``test_chain.py`` builds its scene)."""
    ref = jgen.lidar_room_scan(jax.random.PRNGKey(0), n=2048, room=(8.0, 6.0, 3.0), noise=0.005)
    src = jnormals.estimate_normals(ref, radius=0.8, k=12).transform(jse3.inverse(T_TRUE))
    return (ref, src), (convert.cloud_from_jax(ref, "cpu"), convert.cloud_from_jax(src, "cpu"))


def test_production_chain_from_yaml_matches_jax(room, tmp_path, capsys):
    p = tmp_path / "icp.yaml"
    p.write_text(yaml.safe_dump(PRODUCTION_CHAIN))
    jc, tc = jchain.from_yaml(str(p)), chain.from_yaml(str(p))
    assert tc.config.matcher == "cuda" and jc.config.matcher == "bruteforce"
    assert dataclass_fields(tc.config, "matcher") == dataclass_fields(jc.config, "matcher")
    (jref, jsrc), (tref, tsrc) = room
    jres = jc.register(jsrc, jref, jnp.eye(4))
    k_read, _ = jax.random.split(jax.random.PRNGKey(0))
    tres = tc.register(tsrc, tref, np.eye(4, dtype=np.float32), rand_reading=jax_draws(k_read))
    _assert_same(jres, tres)
    dt, da = _gap(tres.transform.numpy(), T_TRUE)
    assert dt < 0.01 and da < 0.01
    # Both FileLoggers (no file names: stdout) wrote one line a call.
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "PointMatcher::icp" in ln]
    assert len(lines) == 2 and lines[0].split(",")[:2] == lines[1].split(",")[:2]


def dataclass_fields(cfg, *skip):
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name not in skip}


def _plane_cloud(n, seed, z=0.0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    return np.concatenate([xy, np.full((n, 1), z, np.float32)], axis=1)


def _both(jcloud):
    return jcloud, convert.cloud_from_jax(jcloud, "cpu")


def test_vardist_chain_matches_jax():
    """KDTreeVarDistMatcher (test_registry_tail's scenario): half the reading
    carries a hopeless per-point radius, so the match ratio is ~0.5."""
    ref = jnormals.estimate_normals(jmake(jnp.asarray(_plane_cloud(512, 0))), radius=1.0, k=12)
    src_pts = _plane_cloud(256, 1) + np.asarray([[0.05, 0.0, 0.1]], np.float32)
    src = jnormals.estimate_normals(jmake(jnp.asarray(src_pts)), radius=1.0, k=12)
    vd = np.where(np.arange(256) % 2 == 0, 1.0, 1e-4).astype(np.float32)
    src = src.with_attr("maxSearchDist", jnp.asarray(vd))
    spec = {"matcher": {"KDTreeVarDistMatcher": {"knn": 1}},
            "errorMinimizer": "PointToPointErrorMinimizer",
            "transformationCheckers": [{"CounterTransformationChecker": {"maxIterationCount": 4}}]}
    (jref, tref), (jsrc, tsrc) = _both(ref), _both(src)
    tc = chain.from_dict(spec)
    assert tc.config.max_dist_field == "maxSearchDist"
    tres = tc.register(tsrc, tref, np.eye(4, dtype=np.float32))
    _assert_same(jchain.from_dict(spec).register(jsrc, jref, jnp.eye(4)), tres)
    assert 0.3 < float(tres.match_ratio) < 0.7


@pytest.mark.parametrize("soft", [0, 1])
def test_generic_descriptor_chain_matches_jax(room, soft):
    """GenericDescriptorOutlierFilter: the reference's ceiling is lifted by
    0.2 m and carries quality 0 (0.1 in the soft mode, where the weight is
    the quality over its maximum)."""
    (jref, jsrc), _ = room
    xyz = np.array(jref.xyz)
    bad = xyz[:, 2] > 1.9
    xyz[bad, 2] += 0.2
    ref = jnormals.estimate_normals(jmake(jnp.asarray(xyz)), radius=0.8, k=12)
    ref = ref.with_attr("quality", jnp.asarray((~bad).astype(np.float32) + 0.1 * soft))
    spec = {"matcher": {"KDTreeMatcher": {"knn": 1, "maxDist": 0.5}},
            "outlierFilters": [{"GenericDescriptorOutlierFilter": {
                "source": "reference", "descName": "quality", "useSoftThreshold": soft,
                "useLargerThan": 1, "threshold": 0.5}}],
            "errorMinimizer": "PointToPlaneErrorMinimizer",
            "transformationCheckers": [{"CounterTransformationChecker": {"maxIterationCount": 10}}]}
    (jref, tref), tsrc = _both(ref), convert.cloud_from_jax(jsrc, "cpu")
    tc = chain.from_dict(spec)
    assert tc.ref_desc_channel == "quality"
    tres = tc.register(tsrc, tref, np.eye(4, dtype=np.float32))
    _assert_same(jchain.from_dict(spec).register(jsrc, jref, jnp.eye(4)), tres)


def test_generic_descriptor_ignores_a_corrupted_half_plane():
    """test_registry_tail's scenario on the port: matches on the corrupted
    half of the reference (quality 0) get weight 0, so the solve stays put;
    without the filter the corrupted half drags it upward."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import normals
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.pointcloud import make_cloud

    ref_pts = _plane_cloud(512, 2)
    bad = ref_pts[:, 0] > 0
    ref_pts = ref_pts + np.where(bad[:, None], np.asarray([[0.0, 0.0, 0.4]], np.float32), 0.0)
    ref = normals.estimate_normals(make_cloud(ref_pts, device="cpu",
                                              attrs={"quality": (~bad).astype(np.float32)}),
                                   radius=1.0, k=12)
    src = normals.estimate_normals(make_cloud(_plane_cloud(256, 3), device="cpu"),
                                   radius=1.0, k=12)
    spec = {"matcher": {"KDTreeMatcher": {"knn": 1, "maxDist": 1.0}},
            "outlierFilters": [{"GenericDescriptorOutlierFilter": {
                "source": "reference", "descName": "quality", "useSoftThreshold": 0,
                "useLargerThan": 1, "threshold": 0.5}}],
            "errorMinimizer": "PointToPointErrorMinimizer",
            "transformationCheckers": [{"CounterTransformationChecker": {"maxIterationCount": 6}}]}
    res = chain.from_dict(spec).register(src, ref, np.eye(4, dtype=np.float32))
    assert abs(float(res.transform[2, 3])) < 0.05
    spec.pop("outlierFilters")
    res = chain.from_dict(spec).register(src, ref, np.eye(4, dtype=np.float32))
    assert float(res.transform[2, 3]) > 0.1


CHAINS = {
    "point_to_point_with_cov": {
        # A distance gate well above the converged residuals: the covariance
        # sums over a correspondence set that rounding cannot change (a
        # trimmed quantile among near-zero residuals would pick it by rounding).
        "matcher": {"KDTreeMatcher": {"knn": 1, "maxDist": 0.5}},
        "outlierFilters": [{"MaxDistOutlierFilter": {"maxDist": 0.3}}],
        "errorMinimizer": {"PointToPointWithCovErrorMinimizer": {"sensorStdDev": 0.02}},
        "transformationCheckers": [{"CounterTransformationChecker": {"maxIterationCount": 20}},
                                   {"DifferentialTransformationChecker": {
                                       "minDiffRotErr": 0.0005, "minDiffTransErr": 0.001}}]},
    "force4dof": {
        "referenceDataPointsFilters": [{"SurfaceNormalDataPointsFilter": {"knn": 10,
                                                                          "radius": 0.8}}],
        "matcher": {"KDTreeMatcher": {"knn": 1, "maxDist": 0.5}},
        "outlierFilters": [{"TrimmedDistOutlierFilter": {"ratio": 0.9}}],
        "errorMinimizer": {"PointToPlaneErrorMinimizer": {"force4DOF": 1}},
        "transformationCheckers": [{"CounterTransformationChecker": {"maxIterationCount": 15}}]},
    "bound_checker": {
        "referenceDataPointsFilters": [{"SurfaceNormalDataPointsFilter": {"knn": 10,
                                                                          "radius": 0.8}}],
        "matcher": {"KDTreeMatcher": {"knn": 1}},
        "errorMinimizer": "PointToPlaneErrorMinimizer",
        "transformationCheckers": [{"CounterTransformationChecker": {"maxIterationCount": 15}},
                                   {"BoundTransformationChecker": {
                                       "maxRotationNorm": 0.005, "maxTranslationNorm": 0.03}}]},
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_variants_match_jax(room, name):
    """A *WithCov minimizer (the covariance too), PointToPlane's force4DOF,
    and a BoundTransformationChecker that aborts the solve (KDTreeMatcher at
    its default maxDist: inf, every reference tile admitted)."""
    spec = CHAINS[name]
    (jref, jsrc), (tref, tsrc) = room
    if name == "point_to_point_with_cov":
        jref = jnormals.estimate_normals(jref, radius=0.8, k=12)
        tref = convert.cloud_from_jax(jref, "cpu")
    jres = jchain.from_dict(spec).register(jsrc, jref, jnp.eye(4))
    tres = chain.from_dict(spec).register(tsrc, tref, np.eye(4, dtype=np.float32))
    _assert_same(jres, tres)
    if name == "point_to_point_with_cov":
        np.testing.assert_allclose(tres[1].numpy(), np.asarray(jres[1]), rtol=1e-3,
                                   atol=1e-3 * float(np.abs(np.asarray(jres[1])).max()))
    if name == "bound_checker":
        assert bool(tres.diverged) and not bool(tres.converged)
    if name == "force4dof":
        R = tres.transform.numpy()[:3, :3]
        assert abs(R[2, 2] - 1.0) < 1e-6  # yaw only


def test_unknown_modules_and_sections_are_rejected_as_in_jax():
    cases = [
        (lambda m: m.from_dict({"outlierFilters": [{"BogusOutlierFilter": {}}]}),
         "unknown outlier filter"),
        (lambda m: m.FilterPipeline([("NotAFilter", {})]), "unknown DataPointsFilter"),
        (lambda m: m.from_dict({"notASection": []}), "unknown ICP chain sections"),
        (lambda m: m.from_dict({"matcher": "OctreeMatcher"}), "unknown matcher"),
        (lambda m: m.from_dict({"errorMinimizer": "BogusErrorMinimizer"}),
         "unknown error minimizer"),
        (lambda m: m.from_dict({"transformationCheckers": ["BogusTransformationChecker"]}),
         "unknown transformation checker"),
        (lambda m: m.from_dict({"logger": "BogusLogger"}), "unknown logger"),
        (lambda m: m.from_dict({"readingDataPointsFilters": [42]}), "unparseable"),
    ]
    for build, msg in cases:
        for mod in (jchain, chain):
            with pytest.raises(ValueError, match=msg):
                build(mod)


@pytest.mark.parametrize("kind,module,params", [
    ("dataPointsFilter", "randomsampling", {"prob": 0.0}),
    ("dataPointsFilter", "maxquantileonaxis", {"ratio": 1.0}),
    ("dataPointsFilter", "maxquantileonaxis", {"dim": 3}),
    ("outlierFilter", "trimmeddist", {"ratio": 1.5}),
    ("outlierFilter", "surfacenormal", {"maxAngle": "wide"}),
    ("transformationChecker", "counter", {"maxIterationCount": 0}),
    ("matcher", "kdtree", {"maxDist": 0.0}),
])
def test_parameter_bounds_as_in_jax(kind, module, params):
    with pytest.raises(jparam.InvalidParameter) as je:
        jparam.validate(kind, module, params)
    with pytest.raises(parametrizable.InvalidParameter) as te:
        parametrizable.validate(kind, module, params)
    assert str(te.value) == str(je.value)
    parametrizable.validate(kind, module, {})  # absent parameters pass
    # The chain builder applies them.
    if kind == "dataPointsFilter":
        with pytest.raises(parametrizable.InvalidParameter):
            chain.FilterPipeline([(module, params)])


def test_file_logger_records(room, tmp_path):
    info, warn = tmp_path / "info.log", tmp_path / "warn.log"
    spec = dict(CHAINS["force4dof"])
    spec["logger"] = {"FileLogger": {"infoFileName": str(info), "warningFileName": str(warn)}}
    c = chain.from_dict(spec)
    assert isinstance(c.logger, loggers.FileLogger)
    (_, _), (tref, tsrc) = room
    res = c.register(tsrc, tref, np.eye(4, dtype=np.float32))
    c.logger.warning("a warning")
    c.logger.close()
    lines = info.read_text().splitlines()
    assert len(lines) == 1 and lines[0].startswith("PointMatcher::icp - reading 2048 pts")
    assert f"{int(res.iterations)} iterations" in lines[0]
    assert warn.read_text() == "a warning\n"
    for name, cls in (("NullLogger", loggers.NullLogger), ("ConsoleLogger", loggers.ConsoleLogger),
                      ("FileLogger", loggers.FileLogger)):
        assert type(loggers.make_logger(name)) is cls
        assert type(jloggers.make_logger(name)).__name__ == cls.__name__


def test_icp_sequence_matches_jax(room):
    (jref, jsrc), (tref, tsrc) = room
    spec = CHAINS["force4dof"]
    jseq = jsequence.ICPSequence(chain=jchain.from_dict(spec))
    tseq = sequence.ICPSequence(chain=chain.from_dict(spec))
    for seq in (jseq, tseq):
        assert not seq.has_map()
        with pytest.raises(RuntimeError, match="set_map"):
            seq.compute(tsrc if seq is tseq else jsrc, np.eye(4, dtype=np.float32))
    jseq.set_map(jref)
    tseq.set_map(tref)
    assert tseq.has_map()
    for guess in (np.eye(4, dtype=np.float32), np.asarray(T_TRUE)):
        guess = guess.astype(np.float32)
        _assert_same(jseq.compute(jsrc, jnp.asarray(guess)), tseq.compute(tsrc, guess))
    tseq.clear_map()
    assert not tseq.has_map()


def test_register_trace_and_dump_iterations_match_jax(room, tmp_path):
    (jref, jsrc), (tref, tsrc) = room
    cfg_spec = CHAINS["force4dof"]
    jc, tc = jchain.from_dict(cfg_spec), chain.from_dict(cfg_spec)
    jgrid_cloud = jc.process_reference(jref)
    from open3d_slam_advanced_rss_2024_public_tpu.ops import hashgrid as jhashgrid

    jgrid = jhashgrid.passthrough(jgrid_cloud, 1.0)
    tgrid = hashgrid.passthrough(convert.cloud_from_jax(jgrid_cloud, "cpu"), 1.0)
    jt = jinspectors.register_trace(jsrc, jgrid, jnp.eye(4), jc.config)
    paths = inspectors.dump_iterations(tsrc, tgrid, np.eye(4, dtype=np.float32), tc.config,
                                       str(tmp_path), prefix="icp")
    tt = inspectors.register_trace(tsrc, tgrid, np.eye(4, dtype=np.float32), tc.config)
    n = tc.config.max_iterations
    assert len(paths) == n + 1 and tt.transforms.shape == (n, 4, 4)
    for i in range(n):
        dt, da = _gap(np.asarray(jt.transforms[i]), tt.transforms[i])
        assert dt < TOL and da < TOL, (i, dt, da)
    np.testing.assert_allclose(tt.match_ratios, np.asarray(jt.match_ratios), atol=1e-3)
    vtk = sorted(p for p in paths if p.endswith(".vtk"))
    assert len(vtk) == n and vtk[0].endswith("icp-reading-0000.vtk")
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import io

    last = io.load_vtk(vtk[-1], device="cpu")
    moved = tsrc.transform(torch.from_numpy(tt.transforms[-1]))
    np.testing.assert_allclose(last.xyz.numpy(), moved.xyz.numpy(), atol=2e-6)
    rows = open(paths[-1]).read().splitlines()
    assert rows[0] == "iteration,rot_delta,trans_delta,match_ratio,rmse" and len(rows) == n + 1


def test_performance_inspector_and_seeded_pipelines(room, tmp_path):
    (_, _), (tref, tsrc) = room
    tc = chain.from_dict(PRODUCTION_CHAIN | {"logger": "NullLogger"})
    insp = inspectors.PerformanceInspector()
    reg = insp.wrap(tc.register)
    for _ in range(2):
        reg(tsrc, tref, np.eye(4, dtype=np.float32))
    s = insp.summary()
    assert s["iterations"]["count"] == 2 and s["duration_s"]["min"] > 0
    assert "match_ratio: n=2" in insp.dump_stats()
    # A seed gives the same draws; another seed others.
    pipe = tc.reading_filters
    a, b, c = pipe(tsrc, seed=3), pipe(tsrc, seed=3), pipe(tsrc, seed=4)
    assert torch.equal(a.mask, b.mask) and not torch.equal(a.mask, c.mask)
    p = tmp_path / "filters.yaml"
    p.write_text(yaml.safe_dump(PRODUCTION_CHAIN["readingDataPointsFilters"]))
    assert chain.filter_pipeline_from_yaml(str(p)).specs == pipe.specs


def test_chain_moves_to_the_kernel_order():
    """For K1 the filtered clouds go in Morton order; the dense reference
    grid carries the descriptor channel."""
    rng = np.random.default_rng(0)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.pointcloud import make_cloud

    cloud = make_cloud(rng.uniform(-5, 5, (500, 3)).astype(np.float32), device="cpu",
                       attrs={"q": rng.uniform(size=500).astype(np.float32)})
    cfg = chain.from_dict({"matcher": {"KDTreeMatcher": {"maxDist": 0.5}}}).config
    grid = chain.reference_grid(cloud, cfg, "q")
    assert torch.equal(grid.points, hashgrid.morton_sort(cloud, 0.5).xyz)
    assert torch.equal(grid.desc, hashgrid.morton_sort(cloud, 0.5).attr("q"))
    hcfg = chain.from_dict({"matcher": {"KDTreeMatcher": {"maxDist": 0.5}}},
                           matcher_impl="hashgrid").config
    assert chain.reference_grid(cloud, hcfg).table_size == 1 << 14
