"""Every DataPointsFilter of the chain registry, the port against the JAX
package (CPU).

Each of the 28 ``_FILTERS`` entries runs through ``FilterPipeline`` on both
sides, on one 2048-lane room scan (noisy walls, floor and ceiling, kNN
normals, 1900 valid lanes, an ``intensity`` channel).  The random filters
run on JAX's own draws (``jax.random.uniform(fold_in(key, i), (N,))``,
handed to the port's pipeline as ``rand``).  Held: the same mask, points
and normals within 1e-5 on the valid lanes, the same descriptor channels
(names, order) within 1e-5 absolute + 1e-5 relative; eigenvectors (the
surfel normals, eigVectors*) up to sign within 1e-4 where their eigenvalue
is apart from the others (LAPACK against fixed Jacobi sweeps), and kNN
normals within 1e-4 where the plane is well defined.  The
filters that bin directions (normal-space sampling, hidden point removal)
may move a point across a bin edge where ``atan2``/``arcsin`` round
differently: their masks may differ on at most 0.1% of the lanes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_advanced_rss_2024_public_tpu.ops import generators as jgen
from open3d_slam_advanced_rss_2024_public_tpu.ops import normals as jnormals
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import chain as jchain
from open3d_slam_advanced_rss_2024_public_tpu.utils.pointcloud import make_cloud as jmake
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import bruteforce, normals
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import chain
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import convert

N = 2048
N_VALID = 1900
KEY = jax.random.PRNGKey(11)
ATOL = RTOL = 1e-5
BINNING_SHARE = 1e-3


def jax_draws(key):
    """The uniforms JAX's pipeline hands filter i, as the port's ``rand``."""
    def rand(i, n):
        return torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, i), (n,))))
    return rand


@pytest.fixture(scope="module")
def scene():
    room = jgen.lidar_room_scan(jax.random.PRNGKey(3), n=N, room=(8.0, 6.0, 3.0), noise=0.01)
    xyz = np.array(room.xyz)
    mask = np.arange(N) < N_VALID
    rng = np.random.default_rng(5)
    intensity = rng.uniform(0.0, 1.0, N).astype(np.float32)
    jc = jmake(jnp.asarray(xyz), mask=jnp.asarray(mask),
               attrs={"intensity": jnp.asarray(intensity)})
    jc = jnormals.estimate_normals(jc, radius=0.8, k=12)
    return jc, convert.cloud_from_jax(jc, device="cpu")


def organized_scene():
    """A 16 x 64 range image of a tilted wall (the organized filter's input)."""
    rows, cols = 16, 64
    u = np.linspace(-2, 2, cols, dtype=np.float32)
    v = np.linspace(-1, 1, rows, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)
    rng = np.random.default_rng(2)
    pts = np.stack([uu, vv, 0.3 * uu + 0.1 * vv + 3.0 + 0.01 * rng.standard_normal(uu.shape)],
                   -1).reshape(-1, 3).astype(np.float32)
    mask = rng.uniform(size=rows * cols) > 0.05
    jc = jmake(jnp.asarray(pts), mask=jnp.asarray(mask))
    return jc, convert.cloud_from_jax(jc, device="cpu")


FILTERS = [
    ("IdentityDataPointsFilter", {}),
    ("RemoveNaNDataPointsFilter", {}),
    ("MaxDistDataPointsFilter", {"maxDist": 3.0}),
    ("MinDistDataPointsFilter", {"minDist": 2.0}),
    ("DistanceLimitDataPointsFilter", {"dim": 1, "dist": 2.0, "removeInside": 1}),
    ("BoundingBoxDataPointsFilter", {"xMin": -2.0, "xMax": 2.0, "yMin": -2.0, "yMax": 2.0,
                                     "zMin": -1.5, "zMax": 1.0, "removeInside": 0}),
    ("MaxQuantileOnAxisDataPointsFilter", {"ratio": 0.3, "dim": 2}),
    ("MaxDensityDataPointsFilter", {"maxDensity": 150.0}),
    ("SurfaceNormalDataPointsFilter", {"knn": 10, "radius": 0.8}),
    ("SamplingSurfaceNormalDataPointsFilter", {"ratio": 0.6, "knn": 7}),
    ("OrientNormalsDataPointsFilter", {"towardCenter": 0}),
    ("ObservationDirectionDataPointsFilter", {"x": 0.5, "y": -0.2, "z": 0.1}),
    ("IncidenceAngleDataPointsFilter", {}),
    ("RandomSamplingDataPointsFilter", {"prob": 0.6}),
    ("MaxPointCountDataPointsFilter", {"maxCount": 700}),
    ("FixStepSamplingDataPointsFilter", {"startStep": 3}),
    ("ShadowDataPointsFilter", {"eps": 0.3}),
    ("SimpleSensorNoiseDataPointsFilter", {"sensorType": 0, "gain": 2.0}),
    ("VoxelGridDataPointsFilter", {"vSizeX": 0.4}),
    ("NormalSpaceDataPointsFilter", {"nbSample": 500}),
    ("CovarianceSamplingDataPointsFilter", {"nbSample": 400}),
    ("OctreeGridDataPointsFilter", {"maxSizeByNode": 0.5, "samplingMethod": 0}),
    ("HiddenPointRemovalDataPointsFilter", {}),
    ("CutAtDescriptorThresholdDataPointsFilter", {"descName": "ranges", "threshold": 3.0,
                                                  "useLargerThan": 1}),
    ("RemoveSensorBiasDataPointsFilter", {"angleThreshold": 1.0}),
    ("OrganizedCloudSurfaceNormalDataPointsFilter", {"rows": 16, "cols": 64, "knn": 5}),
    ("ElipsoidsDataPointsFilter", {"knn": 8, "samplingMethod": 1, "keepDensities": 1,
                                   "keepEigenValues": 1, "keepEigenVectors": 1,
                                   "keepCovariances": 1, "keepWeights": 1, "keepMeans": 1,
                                   "keepShapes": 1}),
    ("GestaltDataPointsFilter", {"ratio": 0.5, "radius": 1.0, "vSizeX": 0.5, "vSizeY": 0.5,
                                 "vSizeZ": 0.5, "keepMeans": 1, "keepEigenValues": 1,
                                 "keepCovariances": 1}),
]
# More settings of the filters with modes (counted apart from the 28).
MODES = [
    ("OctreeGridDataPointsFilter", {"maxSizeByNode": 0.5, "samplingMethod": 2}),
    ("ElipsoidsDataPointsFilter", {"knn": 7, "samplingMethod": 0, "ratio": 0.5,
                                   "keepNormals": 1, "keepShapes": 1}),
    ("SimpleSensorNoiseDataPointsFilter", {"sensorType": 1}),
    ("DistanceLimitDataPointsFilter", {"dist": 3.5}),
]


def test_registry_has_the_28_filters_of_the_jax_package():
    assert sorted(chain._FILTERS) == sorted(jchain._FILTERS)
    assert len(chain._FILTERS) == 28
    assert sorted(chain._OUTLIER_MAP) == sorted(jchain._OUTLIER_MAP)
    assert sorted(chain._MINIMIZER_MAP) == sorted(jchain._MINIMIZER_MAP)
    assert {chain._canon(n) for n, _ in FILTERS} == set(chain._FILTERS)


def _eig_apart(vals: np.ndarray, j: int) -> np.ndarray:
    """Rows whose j-th eigenvalue is apart from the others by 1e-3 of the
    largest (where the eigenvector is defined to rounding)."""
    scale = np.maximum(np.abs(vals).max(-1), 1e-12)
    gaps = [np.abs(vals[:, j] - vals[:, k]) for k in range(3) if k != j]
    return np.minimum(*gaps) > 1e-3 * scale


def _compare_up_to_sign(a: np.ndarray, b: np.ndarray, rows: np.ndarray, what: str):
    """Vectors a, b [M, 3] equal up to sign on ``rows``."""
    s = np.where((a * b).sum(-1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose((a * s)[rows], b[rows], atol=1e-4, err_msg=what)


def _compare_knn_normals(tout, nt, nj, both, params, name):
    """kNN normals, held as ``test_torch_loop_closure.py`` holds them:
    within 1e-4 (as lines, and with the same orientation) where the plane is
    well defined (smallest eigenvalue below a fifth of the middle one; at
    near-equal eigenvalues the closed-form eigenvector is ill-conditioned),
    and zero on the same lanes."""
    k = int(params["knn"])
    radius = float(params.get("radius", 0.5))
    idx, _, ok = bruteforce.knn(tout.xyz, tout.mask, tout.xyz, radius, k=k)
    nbr = tout.xyz[idx]
    w = ok.float()[..., None]
    mean = (nbr * w).sum(1) / w.sum(1).clamp(min=1.0)
    d = (nbr - mean[:, None]) * w
    ev = torch.linalg.eigvalsh(torch.einsum("nki,nkj->nij", d, d)
                               / w.sum(1).clamp(min=1.0)[..., None])
    planar = both & (ev[:, 0] < 0.2 * ev[:, 1]).numpy() & (ok.sum(-1) >= 5).numpy()
    assert planar.sum() > 0.5 * both.sum(), name
    dots = (nj * nt).sum(-1)[planar]
    assert (1.0 - dots).max() < 1e-4, name
    np.testing.assert_array_equal(np.abs(nj).sum(-1) > 0, np.abs(nt).sum(-1) > 0)


def _check(name, params, jout, tout):
    m_j, m_t = np.array(jout.mask), tout.mask.numpy()
    assert tout.capacity == jout.capacity
    canon = chain._canon(name)
    diff = int((m_j != m_t).sum())
    if canon in ("normalspace", "hiddenpointremoval"):
        assert diff <= BINNING_SHARE * m_j.size, (name, diff)
    elif canon != "gestalt":
        assert diff == 0, (name, diff)
    both = m_j & m_t
    assert both.sum() > 0, name
    np.testing.assert_allclose(tout.xyz.numpy()[both], np.array(jout.xyz)[both], atol=ATOL,
                               err_msg=name)
    assert tout.attr_names == tuple(jout.attr_names), name
    nj, nt = np.array(jout.normals), tout.normals.numpy()
    if canon in ("surfacenormal", "samplingsurfacenormal"):
        _compare_knn_normals(tout, nt, nj, both, params, name)
    elif canon in ("elipsoids", "gestalt"):
        ev = (np.stack([np.array(jout.attr(f"eigValues{j}")) for j in range(3)], -1)
              if "eigValues0" in jout.attr_names else None)
        rows = both if ev is None else both & _eig_apart(ev, 0)
        _compare_up_to_sign(nt, nj, rows, name + " normals")
    else:
        np.testing.assert_allclose(nt[both], nj[both], atol=ATOL, err_msg=name)
    if jout.attrs is None:
        return both
    aj, at = np.array(jout.attrs), tout.attrs.numpy()
    for c, key in enumerate(jout.attr_names):
        if key.startswith("eigVectors") or key.startswith("gestalt"):
            continue
        np.testing.assert_allclose(at[both, c], aj[both, c], atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} {key}")
    if "eigVectors0" in jout.attr_names:
        ev = np.stack([np.array(jout.attr(f"eigValues{j}")) for j in range(3)], -1)
        vj = np.stack([np.array(jout.attr(f"eigVectors{k}")) for k in range(9)], -1)
        vt = np.stack([tout.attr(f"eigVectors{k}").numpy() for k in range(9)], -1)
        for j in range(3):
            _compare_up_to_sign(vt[:, j::3], vj[:, j::3], both & _eig_apart(ev, j),
                                f"{name} eigenvector {j}")
    return both


def _run(scene, name, params):
    jc, tc = scene
    if chain._canon(name) == "organizedcloudsurfacenormal":
        jc, tc = organized_scene()
    if chain._canon(name) == "removenan":
        xyz = np.array(jc.xyz)
        xyz[::97] = np.nan
        jc = jmake(jnp.asarray(xyz), normals=jc.normals, mask=jc.mask,
                   attrs={"intensity": jc.attr("intensity")})
        tc = convert.cloud_from_jax(jc, device="cpu")
    jout = jchain.FilterPipeline([(name, params)])(jc, KEY)
    tout = chain.FilterPipeline([(name, params)])(tc, rand=jax_draws(KEY))
    return jout, tout


@pytest.mark.parametrize("name,params", FILTERS, ids=[n for n, _ in FILTERS])
def test_filter_matches_jax(scene, name, params):
    jout, tout = _run(scene, name, params)
    both = _check(name, params, jout, tout)
    if chain._canon(name) == "gestalt":
        _check_gestalt(jout, tout, both)


@pytest.mark.parametrize("name,params", MODES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(MODES)])
def test_filter_mode_matches_jax(scene, name, params):
    jout, tout = _run(scene, name, params)
    _check(name, params, jout, tout)


def _check_gestalt(jout, tout, both):
    """Gestalt: the keypoint gates may differ only where the JAX package's
    verdict rests on LAPACK's eigenvector sign (a normal within 10 degrees of
    vertical: the gate reads arccos(n_z)); the 4 x 8 polar descriptor is
    held where both keep the keypoint, its angular bins turned by half a
    circle where the normals have opposite signs (the basis flips), within
    1e-5 but for at most 0.1% of the bins (a point on a bin edge)."""
    m_j, m_t = np.array(jout.mask), tout.mask.numpy()
    nz = np.abs(np.array(jout.normals)[:, 2])
    assert ((m_j != m_t) & (nz < np.cos(np.radians(10.0)) - 1e-4)).sum() == 0
    nj, nt = np.array(jout.normals), tout.normals.numpy()
    flip = (nj * nt).sum(-1) < 0
    for prefix in ("gestaltMeans", "gestaltVariances"):
        gj = np.stack([np.array(jout.attr(f"{prefix}{k}")) for k in range(32)], -1)
        gt = np.stack([tout.attr(f"{prefix}{k}").numpy() for k in range(32)], -1)
        gt = np.where(flip[:, None], np.roll(gt.reshape(-1, 4, 8), 4, axis=2).reshape(-1, 32), gt)
        bad = ~np.isclose(gt[both], gj[both], atol=ATOL, rtol=RTOL)
        assert bad.mean() <= BINNING_SHARE, (prefix, int(bad.sum()), bad.size)


def test_eigh_3x3_matches_lapack():
    """The Jacobi eigensystem against float64 LAPACK: eigenvalues within
    1e-6 of the largest, eigenvectors up to sign within 1e-4 where apart."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((4096, 3, 3)).astype(np.float32)
    C = A @ A.transpose(0, 2, 1)
    C[:64] = np.diag([1.0, 2.0, 2.0]).astype(np.float32)  # a repeated eigenvalue
    C[64:128] = 0.0
    ev, V = normals.eigh_3x3(torch.from_numpy(C))
    ev_ref, V_ref = np.linalg.eigh(C.astype(np.float64))
    scale = np.abs(ev_ref).max(-1, keepdims=True) + 1e-30
    assert (np.abs(ev.numpy() - ev_ref) / scale).max() < 1e-6
    V = V.numpy()
    for j in range(3):
        _compare_up_to_sign(V[:, :, j], V_ref[:, :, j], _eig_apart(ev_ref, j), f"column {j}")
    # Orthonormal columns everywhere, repeated eigenvalues included.
    np.testing.assert_allclose(V.transpose(0, 2, 1) @ V, np.broadcast_to(np.eye(3), V.shape),
                               atol=1e-5)
