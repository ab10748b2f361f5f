"""The port's pose graph and submap feedback against the JAX package (CPU).

A 6-node chain with odometry edges, one true loop closure and one false one
goes through both packages' solvers from the same numpy poses and
constraints; the state converters (``utils/convert.py``) carry constraint
lists, ``to_dict`` dumps and whole submaps across, so that
``apply_transforms`` starts from the same submaps on both sides.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from open3d_slam_advanced_rss_2024_public_tpu.models import pose_graph as jpg
from open3d_slam_advanced_rss_2024_public_tpu.models.submap_collection import (
    SubmapCollection as JSubmapCollection)
from open3d_slam_advanced_rss_2024_public_tpu.utils import se3 as jse3
from open3d_slam_advanced_rss_2024_public_tpu.utils.config import load_parameters as jload
from open3d_slam_advanced_rss_2024_public_tpu.utils.pointcloud import make_cloud as jmake
from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pose_graph as pg
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.submap_collection import (
    SubmapCollection)
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import convert
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters

N_NODES, MAX_NODES, MAX_EDGES = 6, 8, 16


def _exp(xi):
    return np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)), np.float64)


@pytest.fixture(scope="module")
def graph():
    """Six poses around a loop; odometry edges with drift, a correct closure
    5 -> 0 and a false closure 1 -> 4 that is 7 m off."""
    rng = np.random.default_rng(0)
    truth = [_exp([0, 0, 2 * np.pi * i / 6, 0, 0, 0]) @ _exp([0, 0, 0, 5.0, 0, 0.2 * i])
             for i in range(N_NODES)]
    info = np.diag([400.0, 400, 400, 100, 100, 100]).astype(np.float32)
    cons = []
    for i in range(N_NODES - 1):
        drift = _exp(np.r_[0.01 * rng.standard_normal(3), 0.08 * rng.standard_normal(3)])
        cons.append(dict(source_id=i, target_id=i + 1, is_odometry=True, information=info,
                         T_source_target=(np.linalg.inv(truth[i]) @ truth[i + 1] @ drift)))
    cons.append(dict(source_id=5, target_id=0, is_odometry=False, information=2 * info,
                     T_source_target=np.linalg.inv(truth[5]) @ truth[0]))
    cons.append(dict(source_id=1, target_id=4, is_odometry=False, information=info,
                     T_source_target=np.linalg.inv(truth[1]) @ truth[4]
                     @ _exp([0.4, 0, 0.3, 6.0, -3.0, 0.5])))
    poses = [truth[0]]
    for c in cons[:N_NODES - 1]:
        poses.append(poses[-1] @ c["T_source_target"])
    cons = [{**c, "T_source_target": c["T_source_target"].astype(np.float32)} for c in cons]
    return [p.astype(np.float32) for p in poses], cons, truth


def _constraints(mod, cons):
    return [mod.Constraint(**c) for c in cons]


def test_residuals_jacobians_and_normal_equations_match_jax(graph):
    poses, cons, _ = graph
    jg = jpg.build_arrays(poses, _constraints(jpg, cons), MAX_NODES, MAX_EDGES)
    tg = pg.build_arrays(poses, _constraints(pg, cons), MAX_NODES, MAX_EDGES, device="cpu")
    # The port cuts its arrays to the nodes and edges in use; the JAX
    # package pads to capacity with masked-out lanes.
    E = len(cons)
    for name in ("node_poses", "node_mask", "edge_src", "edge_dst", "edge_T", "edge_info",
                 "edge_uncertain", "edge_mask"):
        n = N_NODES if name.startswith("node") else E
        assert getattr(tg, name).shape[0] == n, name
        np.testing.assert_array_equal(np.asarray(getattr(jg, name))[:n],
                                      getattr(tg, name).numpy(), err_msg=name)
    assert not np.asarray(jg.node_mask)[N_NODES:].any() and not np.asarray(jg.edge_mask)[E:].any()
    deltas = (0.05 * np.random.default_rng(1).standard_normal((MAX_NODES, 6))).astype(np.float32)
    jr, jJi, jJj = jpg.edge_residuals_and_jacobians(jnp.asarray(deltas), jg)
    r, Ji, Jj = pg.edge_residuals_and_jacobians(torch.from_numpy(deltas[:N_NODES]), tg)
    for a, b in ((jr, r), (jJi, Ji), (jJj, Jj)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a)[:E], atol=2e-5)
    W = np.asarray(jg.edge_info) * np.asarray(jg.edge_mask, np.float32)[:, None, None]
    jH, jb = jpg.assemble_normal_equations(jr, jJi, jJj, jnp.asarray(W), jg.edge_src,
                                           jg.edge_dst, MAX_NODES)
    H, b = pg.assemble_normal_equations(r, Ji, Jj, torch.from_numpy(W[:E]), tg.edge_src,
                                        tg.edge_dst, N_NODES)
    # The JAX package's padding edges (0 -> 0) carry weight 0: the blocks of
    # the nodes in use are the same, the rest of its H and b is empty.
    np.testing.assert_allclose(H.numpy(), np.asarray(jH)[:N_NODES, :N_NODES], rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb)[:N_NODES], rtol=1e-4, atol=1e-2)
    assert np.abs(np.asarray(jH)[0, 0]).max() > 0
    assert not np.asarray(jH)[N_NODES:].any() and not np.asarray(jb)[N_NODES:].any()
    # Duplicate indices accumulate: two parallel edges sum on their blocks.
    twice = pg.assemble_normal_equations(
        torch.cat([r, r[:1]]), torch.cat([Ji, Ji[:1]]), torch.cat([Jj, Jj[:1]]),
        torch.from_numpy(np.concatenate([W[:E], W[:1]])), torch.cat([tg.edge_src, tg.edge_src[:1]]),
        torch.cat([tg.edge_dst, tg.edge_dst[:1]]), N_NODES)[0]
    once = pg.assemble_normal_equations(r[:1], Ji[:1], Jj[:1], torch.from_numpy(W[:1]),
                                        tg.edge_src[:1], tg.edge_dst[:1], N_NODES)[0]
    np.testing.assert_allclose(twice.numpy(), (H + once).numpy(), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("max_iterations", [30, 100])
def test_solve_matches_jax_and_prunes_the_false_closure(graph, max_iterations):
    poses, cons, truth = graph
    jg = jpg.build_arrays(poses, _constraints(jpg, cons), MAX_NODES, MAX_EDGES)
    tg = pg.build_arrays(poses, _constraints(pg, cons), MAX_NODES, MAX_EDGES, device="cpu")
    jX, js, jcost = jpg.solve(jg, jnp.int32(0), 2.0, 0.2, max_iterations=max_iterations)
    X, s, cost = pg.solve(tg, 0, 2.0, 0.2, max_iterations=max_iterations)
    assert X.shape == (N_NODES, 4, 4) and s.shape == (len(cons),)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX)[:N_NODES], atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(js)[:len(cons)], atol=1e-3)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-2, atol=1e-3)
    s = s.numpy()
    assert (s[:5] == 1.0).all() and s[5] > 0.8 and s[6] < 0.2
    assert (np.asarray(js)[len(cons):] == 0).all()
    # The true closure pulled the chain's end back onto the truth.
    before = np.linalg.norm(poses[5][:3, 3] - truth[5][:3, 3])
    after = np.linalg.norm(X.numpy()[5, :3, 3] - truth[5][:3, 3])
    assert after < 0.5 * before
    np.testing.assert_allclose(X.numpy()[0], poses[0], atol=1e-6)   # pinned


def test_packed_solve_and_trimmed_solve_agree(graph):
    poses, cons, _ = graph
    jbuf = jpg.pack_graph(poses, _constraints(jpg, cons), MAX_NODES, MAX_EDGES, reference_node=0,
                          loop_closure_preference=2.0, edge_prune_threshold=0.2)
    buf = pg.pack_graph(poses, _constraints(pg, cons), MAX_NODES, MAX_EDGES, reference_node=0,
                        loop_closure_preference=2.0, edge_prune_threshold=0.2)
    np.testing.assert_array_equal(buf, jbuf)
    again = pg.pack_graph(poses, [], MAX_NODES, MAX_EDGES,
                          edge_block=buf[5 + MAX_NODES * 16:].reshape(MAX_EDGES, 55))
    np.testing.assert_array_equal(again[5:], buf[5:])
    jX, js, _ = jpg.solve_packed(jnp.asarray(jbuf), MAX_NODES, MAX_EDGES, max_iterations=30)
    # Cut to the nodes and edges in use: the poses and weights of the JAX
    # package's padded solve.
    Xt, st, _ = pg.solve_packed(torch.from_numpy(buf), MAX_NODES, MAX_EDGES, N_NODES, len(cons),
                                max_iterations=30)
    assert Xt.shape == (N_NODES, 4, 4) and st.shape == (len(cons),)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(jX)[:N_NODES], atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(js)[:len(cons)], atol=1e-3)
    # The same buffer packed at a larger capacity: the same trimmed graph,
    # the same result bit for bit.
    wide = pg.pack_graph(poses, _constraints(pg, cons), 4 * MAX_NODES, 4 * MAX_EDGES)
    Xw, sw, _ = pg.solve_packed(torch.from_numpy(wide), 4 * MAX_NODES, 4 * MAX_EDGES, N_NODES,
                                len(cons), max_iterations=30)
    assert torch.equal(Xw, Xt) and torch.equal(sw, st)
    # A graph with no edge keeps its poses.
    empty = pg.pack_graph(poses[:2], [], MAX_NODES, MAX_EDGES)
    X0, s0, _ = pg.solve_packed(torch.from_numpy(empty), MAX_NODES, MAX_EDGES, 2, 0)
    np.testing.assert_allclose(X0.numpy(), np.stack(poses[:2]), atol=1e-6)
    assert s0.shape == (1,) and float(s0[0]) == 0.0
    with pytest.raises(ValueError, match="capacity"):
        pg.pack_graph(poses * 2, [], MAX_NODES, MAX_EDGES)


def test_optimization_problem_matches_jax(graph, tmp_path):
    poses, cons, _ = graph
    jop = jpg.OptimizationProblem(MAX_NODES, MAX_EDGES)
    jcons = _constraints(jpg, cons)
    jop.insert_odometry_constraints(jcons[:5] + jcons[:2])      # duplicates dropped
    jop.insert_loop_closure_constraints(jcons[5:])
    # Constraint lists and the JSON dump carry across through convert.
    top = pg.OptimizationProblem(MAX_NODES, MAX_EDGES, device="cpu")
    top.insert_odometry_constraints(convert.constraints_from_jax(jop.odometry_constraints)
                                    + convert.constraints_from_jax(jcons[:2]))
    top.insert_loop_closure_constraints(
        convert.constraints_from_jax(jop.loop_closure_constraints))
    assert len(top.odometry_constraints) == 5 and len(top.loop_closure_constraints) == 2
    assert json.dumps(top.to_dict()) == json.dumps(jop.to_dict())
    (tmp_path / "graph.json").write_text(json.dumps(jop.to_dict()))
    loaded = convert.optimization_problem_from_dict(
        json.loads((tmp_path / "graph.json").read_text()), MAX_NODES, MAX_EDGES, device="cpu")
    assert loaded.to_dict() == top.to_dict()

    jinc = jop.solve(poses, max_iterations=100)
    handle = top.solve_async(poses, max_iterations=100)
    assert top.last_switch_weights is None              # nothing read yet
    tinc = top.resolve_async(handle)
    assert sorted(tinc) == sorted(jinc) == list(range(N_NODES))
    for i in jinc:
        np.testing.assert_allclose(tinc[i], jinc[i], atol=2e-4)
    np.testing.assert_allclose(top.last_switch_weights, jop.last_switch_weights[:7], atol=1e-3)
    assert top.pruned_loop_closures() == jop.pruned_loop_closures() == [1]
    np.testing.assert_allclose(loaded.solve(poses, max_iterations=100)[5], tinc[5], atol=1e-6)
    top.clear_loop_closure_constraints()
    assert top.to_dict()["loop_closure_constraints"] == []


def test_solve_stops_dispatching_after_convergence(graph, monkeypatch):
    """The polled ``done`` flag ends the loop early, with the result of the
    full ``max_iterations`` trips (the carry is frozen once done)."""
    poses, cons, _ = graph
    tg = pg.build_arrays(poses, _constraints(pg, cons), MAX_NODES, MAX_EDGES, device="cpu")
    calls = {"n": 0}
    real = pg.assemble_normal_equations

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)
    monkeypatch.setattr(pg, "assemble_normal_equations", counting)
    X, s, _ = pg.solve(tg, 0, 2.0, 0.2, max_iterations=100)
    polled, cadence = calls["n"], pg.POLL_EVERY
    monkeypatch.setattr(pg, "POLL_EVERY", 1000)
    calls["n"] = 0
    X_full, s_full, _ = pg.solve(tg, 0, 2.0, 0.2, max_iterations=100)
    assert calls["n"] == 100 and polled < 60 and polled % cadence == 0
    assert torch.equal(X, X_full) and torch.equal(s, s_full)


# -- submaps: feedback onto the collection -------------------------------------------------------

def _collection_pair():
    """Three submaps with maps, a parent chain 0 <- 1 <- 2, built by the JAX
    package and carried into the port."""
    over = {"mapper": {"submaps": {"point_capacity": 1024}, "map_builder": {"map_voxel_size": 0.2}}}
    jsc = JSubmapCollection(jload(over).mapper)
    rng = np.random.default_rng(2)
    for i in range(3):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [4.0 * i, 0.5 * i, 0.0]
        jsc._create_new_submap(T, 0.1 * i)
        xyz = (rng.uniform(-3, 3, (600, 3)) * [1, 1, 0.2] + T[:3, 3]).astype(np.float32)
        nrm = np.tile(np.array([0, 0, 1.0], np.float32), (600, 1))
        jsc.insert_scan(jmake(xyz, normals=nrm), T, 0.1 * i)
    for s in jsc.submaps[:2]:
        s.compute_center()
    tsc = SubmapCollection(load_parameters(over).mapper, device="cpu")
    tsc.submaps = [convert.submap_from_jax(s, device="cpu") for s in jsc.submaps]
    tsc.active_idx = jsc.active_idx
    return jsc, tsc


def test_convert_carries_submaps_across():
    jsc, tsc = _collection_pair()
    for js, ts in zip(jsc.submaps, tsc.submaps):
        assert (ts.submap_id, ts.parent_id, ts.n_scans) == (js.submap_id, js.parent_id, js.n_scans)
        np.testing.assert_array_equal(ts.pose, js.pose)
        np.testing.assert_allclose(ts.center(), js.center(), atol=1e-6)
        np.testing.assert_array_equal(ts.map.ptable.numpy(), np.asarray(js.map.ptable))
        assert int(ts.map.count()) == int(js.map.count()) > 100
        assert ts.keys_stale is False and ts.features is None


def test_apply_transforms_matches_jax():
    jsc, tsc = _collection_pair()
    # Node 1 optimized, node 2 follows its parent chain, node 0 pinned.
    incs = {0: np.eye(4, dtype=np.float32),
            1: _exp([0.0, 0.02, 0.15, 0.6, -0.4, 0.05]).astype(np.float32)}
    japplied, tapplied = jsc.apply_transforms(incs), tsc.apply_transforms(incs)
    assert sorted(japplied) == sorted(tapplied) == [0, 1, 2]
    for js, ts in zip(jsc.submaps, tsc.submaps):
        np.testing.assert_allclose(tapplied[ts.submap_id], japplied[js.submap_id], atol=0)
        np.testing.assert_allclose(ts.pose, js.pose, atol=1e-6)
        np.testing.assert_allclose(ts.center(), js.center(), atol=1e-5)
        assert ts.keys_stale == js.keys_stale
        a, b = js.map.cloud, ts.map.cloud
        np.testing.assert_array_equal(np.asarray(a.mask), b.mask.numpy())
        np.testing.assert_allclose(np.asarray(a.xyz)[np.asarray(a.mask)],
                                   b.xyz.numpy()[b.mask.numpy()], atol=1e-5)
    # Closed submap 1 moved by content only; the active one was re-keyed.
    assert [s.keys_stale for s in tsc.submaps] == [False, True, False]
    np.testing.assert_allclose(tapplied[2], incs[1], atol=0)
    # Re-keying bins the moved means anew (means that now share a voxel
    # merge), the same way in both packages.
    tsc.submaps[1].ensure_keys()
    jsc.submaps[1].ensure_keys()
    assert tsc.submaps[1].keys_stale is False
    assert int(tsc.submaps[1].map.count()) == int(jsc.submaps[1].map.count()) > 400


def test_features_and_candidates_match_jax():
    """``compute_features_for_finished`` on the same submap in both packages:
    the same feature cloud, normals up to the planar points, and candidate
    queue."""
    over = {"mapper": {"submaps": {"point_capacity": 2048},
                       "map_builder": {"map_voxel_size": 0.2},
                       "place_recognition": {"feature_voxel_size": 0.5,
                                             "feature_map_normal_estimation_radius": 1.5,
                                             "feature_radius": 2.0, "feature_knn": 16,
                                             "feature_normal_knn": 10,
                                             "feature_point_capacity": 512}}}
    jsc = JSubmapCollection(jload(over).mapper)
    rng = np.random.default_rng(3)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0, 0, 1.0]
    jsc._create_new_submap(T, 0.0)
    xyz = np.concatenate([rng.uniform(-5, 5, (1200, 3)) * [1, 1, 0.01],
                          rng.uniform(-5, 5, (800, 3)) * [1, 0.01, 0.3] + [0, 5, 1.5]]
                         ).astype(np.float32)
    jsc.insert_scan(jmake(xyz), T, 0.0)
    tsc = SubmapCollection(load_parameters(over).mapper, device="cpu")
    tsc.submaps = [convert.submap_from_jax(jsc.submaps[0], device="cpu")]
    for sc in (jsc, tsc):
        sc.finished_queue.append((0, 1.5))
    assert jsc.compute_features_for_finished() == tsc.compute_features_for_finished() == [0]
    assert tsc.pop_loop_closure_candidates() == jsc.pop_loop_closure_candidates() == [(0, 1.5)]
    assert not tsc.finished_queue and not tsc.pop_loop_closure_candidates()
    js, ts = jsc.submaps[0], tsc.submaps[0]
    np.testing.assert_array_equal(np.asarray(js.feature_cloud.mask), ts.feature_cloud.mask.numpy())
    np.testing.assert_allclose(np.asarray(js.feature_cloud.xyz), ts.feature_cloud.xyz.numpy(),
                               atol=1e-5)
    dots = np.abs((np.asarray(js.feature_cloud.normals) * ts.feature_cloud.normals.numpy()).sum(-1))
    m = ts.feature_cloud.mask.numpy()
    assert 100 < m.sum() <= 512 and np.mean(dots[m] > 1 - 1e-3) > 0.95
    assert ts.features.shape == (512, 33) and bool(torch.isfinite(ts.features).all())
    # A submap carried across WITH its features keeps them.
    again = convert.submap_from_jax(js, device="cpu")
    np.testing.assert_array_equal(again.features.numpy(), np.asarray(js.features))
    np.testing.assert_array_equal(again.feature_cloud.xyz.numpy(), np.asarray(js.feature_cloud.xyz))
    tsc.mark_loop_closure_submaps([0, 3])
    assert tsc.loop_closure_submaps == {0, 3}


def test_dense_map_is_built_where_enabled():
    over = {"mapper": {"mapper_localizer": {"is_build_dense_map": True},
                       "submaps": {"point_capacity": 512},
                       "dense_map_builder": {"map_voxel_size": 0.05}}}
    tsc = SubmapCollection(load_parameters(over).mapper, device="cpu")
    tsc.ensure_active(np.eye(4, dtype=np.float32), 0.0)
    assert tsc.active_submap.dense_map is not None
    xyz = np.random.default_rng(4).uniform(-1, 1, (300, 3)).astype(np.float32)
    tsc.insert_dense(pc.make_cloud(torch.from_numpy(xyz)))
    assert int(tsc.active_submap.dense_map.count()) > 250
    assert int(tsc.active_submap.map.count()) == 0
