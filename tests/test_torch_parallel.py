"""The port's multi-chip path (``parallel/``) against the JAX package's (CPU).

The port runs on D = 4 gloo ranks, spawned once for the module; each rank
runs every case and writes its results, as numpy, to a file.  The JAX
package runs the same cases on ``make_mesh(4)`` (4 of conftest's 8
virtual CPU devices) in this process while the ranks work, on the same
seeded inputs: the same row split of the source, the same edge blocks and
the same block owners on both sides.  Each case of ``tests/test_parallel.py``
has its counterpart here; the session runs at 12 scans of 1024 points, 4 a
submap.

The ranks import this module; JAX and the JAX package are imported inside
the functions that compute the reference, so the ranks never load them.
"""
import pathlib
import pickle
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pipeline
from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pose_graph as pg
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import hashgrid, normals, voxel_map
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import icp
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration.icp import ICPConfig
from open3d_slam_advanced_rss_2024_public_tpu_torch.parallel import mesh as pmesh
from open3d_slam_advanced_rss_2024_public_tpu_torch.parallel import (
    distributed_pose_graph, sharded_icp, sharded_map, sharded_session, sharded_slam)
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import convert
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.pointcloud import PointCloud

D = 4
# Seconds a rank's collective waits for the others before it fails.
TIMEOUT_S = 120.0
# The mapper's configuration: the JAX test's, with each rank's patch at its
# table's 4096 lanes (the JAX test gives 8192 to the single-device run) and
# the normal engine that "auto" means to JAX on the CPU, kNN (the port's
# "auto" is K2, whose float32 radius test against JAX's bfloat16 one moves
# the weakly constrained corridor poses by millimetres).
_MAPPER_COMMON = dict(scan_voxel_size=0.15, scan_capacity=1536, crop_min_radius=0.5,
                      crop_max_radius=18.0, map_patch_capacity=4096, map_voxel_size=0.1,
                      min_refinement_fitness=0.3, normal_engine="knn")
_MAPPER_ICP = dict(max_iterations=8, matcher="bruteforce", max_correspondence_dist=0.6)


def _yaw(yaw: float, x: float = 0.0, y: float = 0.0) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:2, 3] = [x, y]
    return T


def _arrays(cloud: PointCloud):
    return cloud.xyz.numpy(), cloud.normals.numpy(), cloud.mask.numpy()


def _cloud(a) -> PointCloud:
    return PointCloud(torch.from_numpy(a[0]), torch.from_numpy(a[1]), torch.from_numpy(a[2]))


def _inputs() -> dict:
    """Every case's inputs as numpy arrays, made from seeds with the port's
    synthetic worlds."""
    inp = {}
    # Sharded ICP: a scan with normals and a copy moved by a known motion.
    world = synthetic.cluttered_world(4, extent=20.0, n_objects=25, device="cpu")
    pose = _yaw(0.0, 8.0, 0.0)
    pose[2, 3] = 1.0
    ref = synthetic.render_scan(world, pose, torch.Generator().manual_seed(0), n_points=2048,
                                max_range=15.0)
    ref = normals.estimate_normals(ref, radius=0.6, k=16)
    T_true = _yaw(0.03, 0.12, -0.08)
    T_true[2, 3] = 0.02
    inp["icp_ref"] = _arrays(ref)
    inp["icp_src"] = _arrays(ref.transform(torch.from_numpy(np.linalg.inv(T_true))))
    inp["icp_T_true"] = T_true
    # Pose graph: the JAX test's square with drifting odometry and a closure.
    gt = [_yaw(0, 0, 0), _yaw(np.pi / 2, 4, 0), _yaw(np.pi, 4, 4), _yaw(-np.pi / 2, 0, 4),
          _yaw(0, 0, 0.4)]
    drift = _yaw(0.02, 0.1, 0.04)
    est, cs = [gt[0]], []
    for i in range(1, 5):
        m = (np.linalg.inv(gt[i - 1].astype(np.float64)) @ gt[i]).astype(np.float32) @ drift
        est.append((est[-1] @ m).astype(np.float32))
        cs.append((i - 1, i, m, np.eye(6, dtype=np.float32) * 100.0, True))
    cs.append((4, 0, (np.linalg.inv(gt[4].astype(np.float64)) @ gt[0]).astype(np.float32),
               np.eye(6, dtype=np.float32) * 100.0, False))
    inp["pg_nodes"], inp["pg_constraints"] = est, cs
    # Sharded map: one scan in the map frame.
    world = synthetic.cluttered_world(7, extent=24.0, n_objects=30, device="cpu")
    pose = _yaw(0.0, 10.0, 0.0)
    pose[2, 3] = 1.0
    scan = synthetic.render_scan(world, pose, torch.Generator().manual_seed(1), n_points=4096,
                                 max_range=14.0)
    inp["map_scan"] = _arrays(scan.transform(torch.from_numpy(pose)))
    # Sharded mapper: the JAX test's 8-scan corridor, odometry with a bias.
    inp["mapper_gt"], inp["mapper_scans"] = _jax_corridor()
    gt = inp["mapper_gt"]
    drift = np.eye(4, dtype=np.float32)
    drift[:3, 3] = [0.02, -0.01, 0.0]
    inp["mapper_deltas"] = [np.eye(4, dtype=np.float32) @ drift] + [
        (np.linalg.inv(gt[i - 1]) @ gt[i]).astype(np.float32) @ drift for i in range(1, 8)]
    # Session: a closed loop of 12 scans, the odometry's yaw biased.
    world = synthetic.cluttered_world(0, extent=16.0, n_objects=24, device="cpu")
    gt = synthetic.loop_trajectory(12, radius=4.0, center=(6.0, 0.0), z=1.0)
    g = torch.Generator().manual_seed(5)
    inp["session_gt"] = gt
    inp["session_scans"] = [_arrays(synthetic.render_scan(world, T, g, n_points=1024,
                                                          max_range=14.0, noise=0.004))
                            for T in gt]
    inp["session_deltas"] = [
        ((np.eye(4, dtype=np.float32) if i == 0 else
          (np.linalg.inv(gt[i - 1]) @ gt[i]).astype(np.float32)) @ _yaw(0.025))
        for i in range(12)]
    return inp


def _jax_corridor():
    """The JAX test's corridor scans, rendered by the JAX package from its
    seeds: a corridor leaves the motion along it weakly constrained, so the
    two packages' renderings of their own seeded corridors differ in how
    well ICP can hold the poses; on the JAX test's own scans the two
    single-device steps agree to a millimetre."""
    import jax

    from open3d_slam_advanced_rss_2024_public_tpu.frontends import synthetic as jsyn

    world = jsyn.corridor_world(jax.random.PRNGKey(31), length=25.0)
    gt = jsyn.straight_trajectory(8, step=0.4)
    keys = jax.random.split(jax.random.PRNGKey(32), 8)
    scans = [jsyn.render_scan(world, gt[i], keys[i], n_points=1536, noise=0.003)
             for i in range(8)]
    return ([np.asarray(T, np.float32) for T in gt],
            [tuple(np.array(x) for x in (c.xyz, c.normals, c.mask)) for c in scans])


def _constraints(rows):
    return [pg.Constraint(a, b, T, info, odo) for a, b, T, info, odo in rows]


# -- the port, on each rank ----------------------------------------------------


def _case_mesh(mesh, inp):
    return {"size": mesh.size, "rank": mesh.rank, "axis": mesh.axis,
            "shape": mesh.shape, "backend": dist.get_backend()}


def _case_icp(mesh, inp):
    cfg = ICPConfig(max_iterations=20)
    ref = _cloud(inp["icp_ref"])
    res = sharded_icp.make_sharded_register(mesh, cfg)(
        _cloud(inp["icp_src"]), hashgrid.passthrough(ref, 0.5), np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError, match="equal blocks"):
        cut = _cloud(inp["icp_src"]).map(lambda t: t[:2046])
        sharded_icp.make_sharded_register(mesh, cfg)(cut, hashgrid.passthrough(ref, 0.5),
                                                     np.eye(4, dtype=np.float32))
    return {"T": res.transform.numpy(), "iterations": int(res.iterations),
            "match_ratio": float(res.match_ratio), "rmse": float(res.rmse)}


def _case_pose_graph(mesh, inp):
    graph = distributed_pose_graph.padded_arrays(
        inp["pg_nodes"], _constraints(inp["pg_constraints"]), 8, 16, device="cpu")
    X, cost = distributed_pose_graph.make_distributed_solver(mesh, 8, 30)(graph, 0, 2.0)
    with pytest.raises(ValueError, match="equal blocks"):
        odd = distributed_pose_graph.padded_arrays(
            inp["pg_nodes"], _constraints(inp["pg_constraints"]), 8, 6, device="cpu")
        distributed_pose_graph.make_distributed_solver(mesh, 8, 30)(odd, 0, 2.0)
    return {"X": X.numpy(), "cost": float(cost)}


def _case_map(mesh, inp):
    empty, insert_fn, nn_fn, gather_fn = sharded_map.make_sharded_map_ops(
        mesh, capacity_per_device=4096, map_voxel_size=0.1, block_size=4.0)
    scan = _cloud(inp["map_scan"])
    maps = insert_fn(empty(), scan)
    xyz, nrm, d2, found = nn_fn(maps, scan.xyz[:512], scan.mask[:512], 0.3)
    full = gather_fn(maps)
    c = maps.cloud
    return {"count": int(maps.count()), "ptable": maps.ptable.numpy(), "acc": maps.acc.numpy(),
            "own_blocks": bool((sharded_map.block_owner(c.xyz[c.mask], 4.0, D)
                                == mesh.rank).all()),
            "nn": (xyz.numpy(), nrm.numpy(), d2.numpy(), found.numpy()),
            "gather": (full.xyz.numpy(), full.mask.numpy())}


def _case_mapper(mesh, inp):
    cfg = pipeline.PipelineConfig(icp=ICPConfig(**_MAPPER_ICP), **_MAPPER_COMMON)
    empty, step = sharded_slam.make_sharded_mapper(mesh, cfg, capacity_per_device=4096,
                                                   block_size=4.0)
    maps, last_ins = empty(), inp["mapper_gt"][0]
    pose, poses, ratios = inp["mapper_gt"][0], [], []
    for a, delta in zip(inp["mapper_scans"], inp["mapper_deltas"]):
        maps, T, mr, last_ins = step(maps, last_ins, _cloud(a), pose @ delta)
        pose = T.numpy()
        poses.append(pose)
        ratios.append(float(mr))
    return {"poses": np.stack(poses), "match_ratio": ratios, "count": int(maps.count())}


def _case_session(mesh, inp):
    res = sharded_session.run_sharded_slam_session(
        mesh, inp["session_gt"], [_cloud(a) for a in inp["session_scans"]],
        inp["session_deltas"], scans_per_submap=4)
    nodes, cs = res.pop("graph")
    res["graph"] = (nodes, [(c.source_id, c.target_id, c.T_source_target, c.information,
                             c.is_odometry) for c in cs])
    return res


def _case_refusals(mesh, inp):
    # A sharded loop that polls, and a mesh that does not span the group.
    cfg = ICPConfig(matcher="sharded", shard_axis=mesh.axis)
    ref = hashgrid.passthrough(_cloud(inp["icp_ref"]), 0.5)
    with pytest.raises(ValueError, match="poll_every"):
        icp.register(_cloud(inp["icp_src"]), ref, torch.eye(4), cfg, poll_every=5)
    with pytest.raises(ValueError, match="every rank"):
        pmesh.make_mesh(D + 1, device="cpu")
    return {"ok": True}


CASES = {"mesh": _case_mesh, "icp": _case_icp, "pose_graph": _case_pose_graph,
         "map": _case_map, "mapper": _case_mapper, "session": _case_session,
         "refusals": _case_refusals}


def _rank_main(rank: int, store: str, tmp: str) -> None:
    """One rank: every case in turn; a case that raises records its
    traceback (every rank raises alike, before any collective is left
    unmatched)."""
    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    inp = pickle.loads((tmp / "inputs.pkl").read_bytes())
    sharded_slam.init_distributed(store, D, rank, device="cpu", timeout=TIMEOUT_S)
    try:
        mesh = pmesh.make_mesh(D, device="cpu")
        out = {}
        for name, case in CASES.items():
            try:
                out[name] = case(mesh, inp)
            except Exception:  # reported by the case's test in the parent
                out[name] = {"error": traceback.format_exc()}
        (tmp / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


# -- the JAX package and the single-device port, in this process ---------------


def _jax_reference(inp) -> dict:
    import jax.numpy as jnp

    from open3d_slam_advanced_rss_2024_public_tpu.models import pipeline as jpipe
    from open3d_slam_advanced_rss_2024_public_tpu.models import pose_graph as jpg
    from open3d_slam_advanced_rss_2024_public_tpu.ops import hashgrid as jhg
    from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import ICPConfig as JICP
    from open3d_slam_advanced_rss_2024_public_tpu.parallel import make_mesh
    from open3d_slam_advanced_rss_2024_public_tpu.parallel.distributed_pose_graph import (
        make_distributed_solver)
    from open3d_slam_advanced_rss_2024_public_tpu.parallel.sharded_icp import (
        make_sharded_register)
    from open3d_slam_advanced_rss_2024_public_tpu.parallel.sharded_map import (
        make_sharded_map_ops)
    from open3d_slam_advanced_rss_2024_public_tpu.parallel.sharded_slam import (
        make_sharded_mapper)
    from open3d_slam_advanced_rss_2024_public_tpu.utils.pointcloud import PointCloud as JCloud

    def jcloud(a):
        return JCloud(xyz=jnp.asarray(a[0]), normals=jnp.asarray(a[1]), mask=jnp.asarray(a[2]))

    mesh = make_mesh(D)
    out = {"mesh_size": mesh.shape["data"]}
    res = make_sharded_register(mesh, JICP(max_iterations=20))(
        jcloud(inp["icp_src"]), jhg.passthrough(jcloud(inp["icp_ref"]), 0.5), jnp.eye(4))
    out["icp"] = {"T": np.asarray(res.transform), "iterations": int(res.iterations)}
    graph = jpg.build_arrays(inp["pg_nodes"], [jpg.Constraint(*c) for c in inp["pg_constraints"]],
                             max_nodes=8, max_edges=16)
    out["pg_graph"] = graph
    out["pg_X"] = np.asarray(make_distributed_solver(mesh, 8, 30)(graph, jnp.int32(0),
                                                                  jnp.float32(2.0))[0])
    empty, insert_fn, nn_fn, gather_fn = make_sharded_map_ops(mesh, capacity_per_device=4096,
                                                              map_voxel_size=0.1, block_size=4.0)
    scan = jcloud(inp["map_scan"])
    maps = insert_fn(empty(), scan)
    out["map_maps"] = maps
    out["map_count"] = np.asarray((maps.occupied & (maps.weight > 0)).sum(axis=1))
    out["map_nn"] = [np.asarray(x) for x in nn_fn(maps, scan.xyz[:512], scan.mask[:512], 0.3)]
    full = gather_fn(maps)
    out["map_gather"] = (np.asarray(full.xyz), np.asarray(full.mask))
    cfg = jpipe.PipelineConfig(icp=JICP(**_MAPPER_ICP), **_MAPPER_COMMON)
    empty, step = make_sharded_mapper(mesh, cfg, capacity_per_device=4096, block_size=4.0)
    maps, last_ins = empty(), jnp.asarray(inp["mapper_gt"][0])
    pose, poses = inp["mapper_gt"][0], []
    for a, delta in zip(inp["mapper_scans"], inp["mapper_deltas"]):
        maps, T, _, last_ins = step(maps, last_ins, jcloud(a), jnp.asarray(pose @ delta))
        pose = np.asarray(T)
        poses.append(pose)
    out["mapper_poses"] = np.stack(poses)
    return out


def _single_device_mapper(inp) -> np.ndarray:
    """The port's single-device step on the mapper's scans (the JAX test's
    single-device configuration: a 2^14-slot table, an 8192-point patch)."""
    cfg = pipeline.PipelineConfig(icp=ICPConfig(**_MAPPER_ICP),
                                  **dict(_MAPPER_COMMON, map_patch_capacity=8192))
    state = pipeline.init_state(1 << 14, inp["mapper_gt"][0], device="cpu")
    poses = []
    for a, delta in zip(inp["mapper_scans"], inp["mapper_deltas"]):
        state, _ = pipeline.mapper_step(state, _cloud(a), state.pose @ torch.from_numpy(delta),
                                        cfg)
        poses.append(state.pose.numpy())
    return np.stack(poses)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    inp = _inputs()
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(inp))
    ctx = mp.start_processes(_rank_main, args=(f"file://{tmp / 'store'}", str(tmp)),
                             nprocs=D, join=False, start_method="spawn")
    try:
        ref = _jax_reference(inp)
        single = _single_device_mapper(inp)
    finally:
        while not ctx.join():
            pass
    ranks = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(D)]
    return inp, ranks, ref, single


def _case(ranks, name):
    outs = [r[name] for r in ranks]
    for o in outs:
        assert "error" not in o, o.get("error")
    return outs


def _same_on_every_rank(outs, key):
    for o in outs[1:]:
        np.testing.assert_array_equal(o[key], outs[0][key])


def test_mesh_construction(runs):
    _, ranks, ref, _ = runs
    outs = _case(ranks, "mesh")
    assert [o["rank"] for o in outs] == list(range(D))
    assert {(o["size"], o["axis"], o["backend"]) for o in outs} == {(D, "data", "gloo")}
    assert outs[0]["shape"] == {"data": ref["mesh_size"]}


def test_sharded_icp_matches_jax(runs):
    inp, ranks, ref, _ = runs
    outs = _case(ranks, "icp")
    _same_on_every_rank(outs, "T")
    T, T_jax = outs[0]["T"], ref["icp"]["T"]
    # Within 5 mm and 2e-3 of JAX's, in the same number of trips.
    assert np.linalg.norm(T[:3, 3] - T_jax[:3, 3]) < 5e-3
    np.testing.assert_allclose(T[:3, :3], T_jax[:3, :3], atol=2e-3)
    assert outs[0]["iterations"] == ref["icp"]["iterations"]
    # And the motion recovered.
    assert np.linalg.norm(T[:3, 3] - inp["icp_T_true"][:3, 3]) < 0.03


def test_distributed_pose_graph_matches_jax_and_host_solver(runs):
    inp, ranks, ref, _ = runs
    outs = _case(ranks, "pose_graph")
    _same_on_every_rank(outs, "X")
    X = outs[0]["X"]
    np.testing.assert_allclose(X[:5], ref["pg_X"][:5], atol=1e-3)
    # The JAX graph carried across is the port's padded graph.
    a = convert.pose_graph_arrays_from_jax(ref["pg_graph"], device="cpu")
    b = distributed_pose_graph.padded_arrays(inp["pg_nodes"], _constraints(inp["pg_constraints"]),
                                             8, 16, device="cpu")
    for f in ("node_poses", "node_mask", "edge_src", "edge_dst", "edge_T", "edge_info",
              "edge_uncertain", "edge_mask"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    # The single-process solver reaches the same optimum (the JAX test's bar).
    X_host, _, _ = pg.solve(pg.build_arrays(inp["pg_nodes"], _constraints(inp["pg_constraints"]),
                                            8, 16, device="cpu"), 0, 2.0, 0.2, max_iterations=30)
    np.testing.assert_allclose(X[:5], X_host.numpy()[:5], atol=5e-3)


def test_sharded_map_matches_jax(runs):
    inp, ranks, ref, _ = runs
    outs = _case(ranks, "map")
    # Each rank holds JAX's table of its device, slot for slot.
    np.testing.assert_array_equal([o["count"] for o in outs], ref["map_count"])
    for r, o in enumerate(outs):
        mine = convert.voxel_map_shard_from_jax(ref["map_maps"], r, device="cpu")
        np.testing.assert_array_equal(o["ptable"], mine.ptable.numpy())
        np.testing.assert_allclose(o["acc"], mine.acc.numpy(), atol=1e-4)
        assert o["own_blocks"]
    assert sum(o["count"] > 0 for o in outs) >= 3 and sum(o["count"] for o in outs) > 1000
    # The cross-shard nearest neighbours.
    xyz, _, d2, found = outs[0]["nn"]
    j_xyz, _, j_d2, j_found = ref["map_nn"]
    np.testing.assert_array_equal(found, j_found)
    assert found[inp["map_scan"][2][:512]].mean() > 0.95
    np.testing.assert_allclose(d2[found], j_d2[found], atol=1e-5)
    np.testing.assert_allclose(xyz[found], j_xyz[found], atol=1e-4)
    # The gathered map: JAX's occupied set, lane for lane.
    g_xyz, g_mask = outs[0]["gather"]
    np.testing.assert_array_equal(g_mask, ref["map_gather"][1])
    np.testing.assert_allclose(g_xyz[g_mask], ref["map_gather"][0][g_mask], atol=1e-4)
    # Empty tables stack as JAX's do.
    st = sharded_map.stack_empty_maps(D, 4096, device="cpu")
    assert st.ptable.shape == (D, 4096) and not bool(st.occupied.any())
    assert torch.equal(sharded_map.local_view(st, 2).ptable, voxel_map.empty(4096, "cpu").ptable)


def test_sharded_mapper_matches_jax_and_single_device(runs):
    inp, ranks, ref, single = runs
    outs = _case(ranks, "mapper")
    _same_on_every_rank(outs, "poses")
    poses = outs[0]["poses"]
    for other in (ref["mapper_poses"], single):
        assert np.linalg.norm(poses[:, :3, 3] - other[:, :3, 3], axis=-1).max() < 5e-3
        np.testing.assert_allclose(poses[:, :3, :3], other[:, :3, :3], atol=2e-3)
    # The map spans the ranks.
    assert sum(o["count"] > 0 for o in outs) >= 3


def test_sharded_session_matches_jax(runs):
    import jax.numpy as jnp

    from open3d_slam_advanced_rss_2024_public_tpu.models import pose_graph as jpg
    from open3d_slam_advanced_rss_2024_public_tpu.parallel import make_mesh
    from open3d_slam_advanced_rss_2024_public_tpu.parallel.distributed_pose_graph import (
        make_distributed_solver)
    from open3d_slam_advanced_rss_2024_public_tpu.parallel.sharded_session import comm_volume

    _, ranks, _, _ = runs
    outs = _case(ranks, "session")
    _same_on_every_rank(outs, "solved")
    res = outs[0]
    assert res["n_submaps"] == 3
    assert res["lc_found"]
    assert res["ate_after"] < res["ate_before"]
    assert res["comm"] == comm_volume(1024, 6, 3, sharded_session.SOLVE_ITERATIONS)
    # The distributed solve against JAX's on the session's own graph.
    nodes, cs = res["graph"]
    max_edges = -(-len(cs) // D) * D
    graph = jpg.build_arrays(nodes, [jpg.Constraint(*c) for c in cs], max_nodes=len(nodes),
                             max_edges=max_edges)
    X_jax = make_distributed_solver(make_mesh(D), len(nodes), sharded_session.SOLVE_ITERATIONS)(
        graph, jnp.int32(0), jnp.float32(2.0))[0]
    np.testing.assert_allclose(res["solved"], np.asarray(X_jax), atol=1e-3)


def test_sharded_loops_refuse_what_would_desynchronise_the_ranks(runs):
    _, ranks, _, _ = runs
    assert all(o["ok"] for o in _case(ranks, "refusals"))


def test_sharded_matcher_without_a_mesh_raises():
    cfg = ICPConfig(matcher="sharded", shard_axis="no_such_axis")
    with pytest.raises(ValueError, match="no mesh has the axis"):
        icp.check_supported(cfg)
    with pytest.raises(ValueError, match="needs shard_axis"):
        icp.check_supported(ICPConfig(matcher="sharded"))
    g = torch.Generator().manual_seed(0)
    cloud = PointCloud(torch.rand((64, 3), generator=g), torch.zeros((64, 3)),
                       torch.ones(64, dtype=torch.bool))
    with pytest.raises(ValueError, match="no mesh has the axis"):
        icp.register(cloud, hashgrid.passthrough(cloud, 0.5), torch.eye(4), cfg)
    with pytest.raises(RuntimeError, match="init_distributed"):
        pmesh.make_mesh(device="cpu")
