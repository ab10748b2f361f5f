"""Standalone map visualizer node.

Counterpart of the JAX package's ``frontends/visualizer_node.py``: the
analogue of the reference's ``visualizer_node``
(reference: ros/open3d_slam_ros/src/visualizer_node.cpp:20-60 — loads a
PCD map and republishes it periodically for RViz).  Without ROS, the
"topic" is an HTTP endpoint: this node serves a map file or a live
visualization bundle directory (the output of
``SlamWrapper.start_visualization``) so any viewer or downstream tool can
poll the latest complete artifacts.  stdlib-only (http.server).

Usage:
    python -m open3d_slam_advanced_rss_2024_public_tpu_torch.frontends.visualizer_node \
        --dir /path/to/viz_bundle --port 8008
    python -m ...visualizer_node --map map.pcd --port 8008
"""
from __future__ import annotations

import argparse
import functools
import html
import http.server
import os
import shutil
import sys
import tempfile
import threading


class _BundleHandler(http.server.SimpleHTTPRequestHandler):
    """Serves the bundle directory with a minimal auto-refreshing index.

    When a SLAM runtime is attached (``serve(..., slam=...)``), also
    exposes the interactive localization-initialization surface — the
    HTTP analogue of the reference's RViz flow (SlamMapInitializer.cpp:
    28-200: ``/initialpose`` topic + interactive marker +
    ``initialize_slam`` Trigger service):

      POST /initialpose       {"x","y","z","roll","pitch","yaw"(deg)} or
                              {"matrix": [16 floats, row-major]}
                              -> sets the map->sensor initial transform
                              and writes initial_pose.json to the bundle.
      POST /initialize_slam   commits the initialization (runs the
                              attached SlamMapInitializer when present,
                              e.g. loading the prior map).
    """

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json_response(self, code: int, payload: dict) -> None:
        import json

        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        import json

        slam = getattr(self, "slam", None)
        if slam is None:
            self._json_response(404, {"error": "no SLAM runtime attached"})
            return
        n = int(self.headers.get("Content-Length", 0))
        try:
            req = json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError as e:
            self._json_response(400, {"error": f"bad JSON: {e}"})
            return
        if self.path == "/initialpose":
            import numpy as np

            try:
                if "matrix" in req:
                    T = np.asarray(req["matrix"],
                                   np.float32).reshape(4, 4)
                else:
                    from ..models.map_initializer import pose_from_config

                    class _P:
                        x = float(req.get("x", 0.0))
                        y = float(req.get("y", 0.0))
                        z = float(req.get("z", 0.0))
                        roll = float(req.get("roll", 0.0))
                        pitch = float(req.get("pitch", 0.0))
                        yaw = float(req.get("yaw", 0.0))

                    T = pose_from_config(_P)
            except (ValueError, TypeError) as e:
                self._json_response(400, {"error": str(e)})
                return
            slam.set_initial_transform(T)
            # Preview export (≙ the reference's aligned-cloud preview).
            preview = os.path.join(self.directory, "initial_pose.json")
            with open(preview + ".tmp", "w") as f:
                json.dump({"map_to_range_sensor": T.tolist()}, f)
            os.replace(preview + ".tmp", preview)
            self._json_response(200, {"status": "initial pose set",
                                      "pose": T.tolist()})
        elif self.path == "/initialize_slam":
            init = getattr(self, "initializer", None)
            if init is not None:
                init.initialize()
            self._json_response(200, {
                "status": "initialized",
                "pose": slam.mapper.map_to_range_sensor.tolist()})
        else:
            self._json_response(404, {"error": f"unknown endpoint {self.path}"})

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            entries = sorted(os.listdir(self.directory))
            rows = "".join(
                f'<li><a href="/{html.escape(e)}">{html.escape(e)}</a> '
                f'({os.path.getsize(os.path.join(self.directory, e))} B)</li>'
                for e in entries if ".tmp" not in e)
            body = (f"<html><head><meta http-equiv=refresh content=2>"
                    f"<title>open3d_slam map</title></head><body>"
                    f"<h3>Live SLAM visualization bundle</h3>"
                    f"<ul>{rows}</ul></body></html>").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        super().do_GET()


def serve(directory: str, port: int = 8008, background: bool = False,
          host: str = "127.0.0.1", slam=None, initializer=None):
    """Serve ``directory`` on ``host:port``; returns the server (background
    mode) or blocks forever.  Binds loopback by default (the bundle
    exposes the live map — pass host="0.0.0.0" explicitly to serve other
    interfaces).

    ``slam``: a SlamWrapper to attach the interactive initialization
    endpoints to (POST /initialpose, /initialize_slam — see
    _BundleHandler); ``initializer``: an optional SlamMapInitializer run
    by /initialize_slam."""
    cls = _BundleHandler
    if slam is not None:
        cls = type("_BoundBundleHandler", (_BundleHandler,),
                   {"slam": slam, "initializer": initializer})
    handler = functools.partial(cls, directory=directory)
    server = http.server.ThreadingHTTPServer((host, port), handler)
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True,
                             name="viz-http")
        t.start()
        return server
    print(f"serving {directory} on http://{host}:{port}", file=sys.stderr)
    server.serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--dir", help="live visualization bundle directory")
    g.add_argument("--map", help="single map file (pcd/ply) to serve")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (default loopback; use 0.0.0.0 to "
                         "expose on all interfaces)")
    args = ap.parse_args(argv)
    if args.map:
        d = tempfile.mkdtemp(prefix="o3dslam_viz_")
        shutil.copy(args.map, os.path.join(d, os.path.basename(args.map)))
        serve(d, args.port, host=args.host)
    else:
        serve(args.dir, args.port, host=args.host)


if __name__ == "__main__":
    main()
