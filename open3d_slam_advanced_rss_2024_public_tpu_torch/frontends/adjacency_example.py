"""Adjacency-graph example.

Counterpart of the JAX package's ``frontends/adjacency_example.py``, the
equivalent of the reference's demo node
(reference: ros/open3d_slam_ros/src/adjacency_graph_example_node.cpp:
builds a toy 13-node submap adjacency graph, marks two loop-closure
submaps, and prints BFS distances to the nearest loop-closure submap —
the spacing gate PlaceRecognition uses,
AdjacencyMatrix::getDistanceToNearestLoopClosureSubmap).

Run:  python -m open3d_slam_advanced_rss_2024_public_tpu_torch.frontends.adjacency_example
"""
from __future__ import annotations

from ..models.submap import AdjacencyMatrix


def create_toy_example() -> AdjacencyMatrix:
    """The reference's toy graph (adjacency_graph_example_node.cpp:23-41)."""
    g = AdjacencyMatrix()
    for a, b in [(0, 1), (0, 4), (4, 5), (3, 4), (1, 3), (2, 1), (2, 6),
                 (6, 7), (3, 7), (4, 9), (3, 8), (8, 11), (12, 11), (12, 10),
                 (7, 10)]:
        g.add_edge(a, b)
    return g


def main() -> None:
    g = create_toy_example()
    print("adjacency:", {k: sorted(v) for k, v in sorted(g._adj.items())})
    loop_closure_submaps = {10, 2}
    for node in (0, 1, 7, 5, 3, 8, 11):
        d = g.bfs_distance(node, loop_closure_submaps)
        print(f"distance from {node} to nearest loop-closure submap: {d}")


if __name__ == "__main__":
    main()
