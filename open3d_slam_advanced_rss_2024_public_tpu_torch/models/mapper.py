"""Scan-to-map mapper — the hot-path owner.

Counterpart of the JAX package's ``models/mapper.py`` (reference
Mapper.cpp:33-553): initial guess = previous refined pose x odometry
delta, scan-to-map ICP, fitness and min-motion gates, map fusion, submap
lifecycle.

Host/device split.  Accepted scans queue on the host; every
``pose_readback_lag`` (K) scans the queue is stacked into one lag-K block
and handed to ``pipeline.mapper_step_block_shared_ref``, whose kernels are
enqueued on the current CUDA stream with no host synchronisation.  The
block's small readback tensors (poses, fitness, insert flags, map count,
drop counter) are copied to pinned host memory without waiting, and a
CUDA event is recorded after the copies.  A reader thread waits on each
block's event in order and runs the host bookkeeping (trajectory buffers,
fitness stats, submap rollover, overflow eviction) under the lock, so
the caller thread only dispatches, throttled by a bounded in-flight
window.

State ownership invariant: while ``self._state`` is set, the live map is
the chained device state and the active submap's ``map`` may be one flush
stale; ``materialize()`` flushes and hands the table back to the submap
before any external read.
"""
from __future__ import annotations

import dataclasses
import threading
import traceback
import warnings
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from ..ops import cuda_nn
from ..ops import voxel_map as vm
from ..ops.registration.icp import ICPConfig, resolve_matcher
from ..utils import timing
from ..utils.config import SlamParameters
from ..utils.device import HostCopy, resolve_device, to_device
from ..utils.pointcloud import SENTINEL, PointCloud, concatenate, empty_cloud, stack
from ..utils.timebuf import TransformInterpolationBuffer
from . import pipeline
from .submap_collection import SubmapCollection


def icp_config_from_params(params: SlamParameters) -> ICPConfig:
    reg = params.mapper.mapper_localizer.scan_to_map_registration
    minimizer = {
        "PointToPlaneIcp": "point_to_plane",
        "PointToPointIcp": "point_to_point",
        "GeneralizedIcp": "gicp",
    }[reg.scan_to_map_refinement_type]
    return ICPConfig(
        matcher=resolve_matcher(reg.matcher),
        max_iterations=reg.icp.max_n_iter,
        max_correspondence_dist=reg.icp.max_correspondence_dist,
        trimmed_ratio=reg.trimmed_ratio,
        normal_max_angle=reg.normal_max_angle,
        use_normal_gate=(minimizer == "point_to_plane"),
        min_diff_rot=reg.min_diff_rot,
        min_diff_trans=reg.min_diff_trans,
        smooth_length=reg.smooth_length,
        minimizer=minimizer,
    )


def pipeline_config_from_params(params: SlamParameters) -> pipeline.PipelineConfig:
    """SlamParameters -> the step's configuration."""
    ml = params.mapper.mapper_localizer
    reg = ml.scan_to_map_registration
    sp = reg.scan_processing
    crop = sp.scan_cropping
    return pipeline.PipelineConfig(
        icp=icp_config_from_params(params),
        scan_voxel_size=sp.voxel_size,
        scan_capacity=sp.point_capacity,
        crop_min_radius=crop.cropping_radius_min,
        crop_max_radius=crop.cropping_radius_max,
        map_patch_capacity=reg.map_patch_capacity,
        map_voxel_size=params.mapper.map_builder.map_voxel_size,
        min_refinement_fitness=(0.0 if ml.ignore_minimum_refinement_fitness
                                else reg.min_refinement_fitness),
        min_movement_between_steps=ml.min_movement_between_mapping_steps,
    )


@dataclasses.dataclass
class MapperStats:
    scans_processed: int = 0
    scans_rejected_low_fitness: int = 0
    out_of_order: int = 0
    insertions: int = 0
    # Voxels dropped by the fixed-capacity table, accumulated monotonically
    # across table swaps (rollover, eviction).
    map_voxels_dropped: int = 0
    # Finalized records evicted unread because no consumer drained them.
    finalized_evicted: int = 0


@dataclasses.dataclass
class _QueuedScan:
    """One scan accepted but not yet dispatched."""

    time: float
    scan: PointCloud
    motion: np.ndarray      # odometry delta fed as the on-device guess
    insert_enable: bool
    scan_id: Optional[int] = None  # the tracer's scan id (``timing.set_scan``)


@dataclasses.dataclass
class _InflightBlock:
    """One dispatched lag-K block awaiting its readback."""

    items: List[_QueuedScan]
    outs: pipeline.StepOutput   # stacked [K, ...] device outputs
    readback: HostCopy          # pose, match_ratio, inserted, map_count, dropped
                                # (+ ICP iterations while the tracer is on)
    # Set when a later-processed rollover made this block's device fusion
    # land in the closed submap: its records re-fuse into the fresh chain.
    tail: bool = False


@dataclasses.dataclass
class Finalized:
    """One scan's host-visible result.  ``merged`` is the preprocessed scan
    in map frame as a zero-arg thunk (slicing the stacked block output
    enqueues device ops, so it resolves lazily), or None for scans that
    never ran the device step."""

    time: float
    pose: np.ndarray
    merged: object
    raw: Optional[PointCloud]
    fitness: float = 1.0
    inserted: bool = False


def _make_pad_scan(template: PointCloud) -> PointCloud:
    """An all-invalid scan with the template's shapes: it matches nothing,
    keeps the pose, and is never inserted."""
    return PointCloud(xyz=torch.full_like(template.xyz, SENTINEL),
                      normals=torch.zeros_like(template.normals),
                      mask=torch.zeros_like(template.mask),
                      attrs=None if template.attrs is None else torch.zeros_like(template.attrs),
                      attr_names=template.attr_names)


class Mapper:
    """The scan-to-map mapper.  ``device`` defaults to ``cuda`` and the
    constructor raises where no CUDA device exists; tests pass
    ``device="cpu"``, where every kernel wrapper takes its plain twin."""

    def __init__(self, params: SlamParameters,
                 odom_buffer: Optional[TransformInterpolationBuffer] = None,
                 device=None):
        self.device = resolve_device(device)
        self.params = params
        self.icp_cfg = icp_config_from_params(params)
        self.pipe_cfg = pipeline_config_from_params(params)
        self._validate_map_extent(params)
        self.submaps = SubmapCollection(params.mapper, device=self.device)
        self.odom_buffer = odom_buffer if odom_buffer is not None else TransformInterpolationBuffer()
        self.map_to_range_sensor = np.eye(4, dtype=np.float32)
        self.map_to_range_sensor_prev = np.eye(4, dtype=np.float32)
        self.map_to_range_sensor_buffer = TransformInterpolationBuffer()
        self.best_guess_buffer = TransformInterpolationBuffer()
        self.calibration = np.eye(4, dtype=np.float32)
        self.last_measurement_time: Optional[float] = None
        self.last_insertion_pose = np.eye(4, dtype=np.float32)
        self.stats = MapperStats()
        self.is_new_value_set = False
        ml = params.mapper.mapper_localizer
        self.is_use_initial_map = ml.is_use_map_initialization
        self.is_merge_scans_into_map = ml.is_merge_scans_into_map
        self.init_time: Optional[float] = None
        self._state: Optional[pipeline.MapState] = None
        self._queue: List[_QueuedScan] = []
        self._inflight: Deque[_InflightBlock] = deque()
        self.readback_lag = max(int(ml.pose_readback_lag), 1)
        self._pad_scan: Optional[PointCloud] = None
        self.finalized: Deque[Finalized] = deque()
        self.finalized_cap = 4096
        self._dropped_seen = 0
        # One lock serializes state mutation between the caller thread and
        # the reader thread.
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._reader: Optional[threading.Thread] = None
        self.max_inflight_blocks = 4
        # The first scan's ICP iterations (tracer on): read once a later
        # block's readback has landed, which the stream orders after them.
        self._first_scan_trips: List[HostCopy] = []

    @staticmethod
    def _validate_map_extent(params: SlamParameters) -> None:
        """The voxel table addresses a ±512-cell cube around the first
        insert's centroid: reject a crop radius beyond it, warn when crop +
        submap size can reach past it."""
        crop = params.mapper.mapper_localizer.scan_to_map_registration \
            .scan_processing.scan_cropping
        half = vm._HALF * params.mapper.map_builder.map_voxel_size
        if crop.cropping_radius_max > half:
            raise ValueError(
                f"scan crop radius {crop.cropping_radius_max} m exceeds the voxel "
                f"table's addressable half-extent {half:.1f} m (= 512 x "
                f"map_voxel_size {params.mapper.map_builder.map_voxel_size})")
        reach = crop.cropping_radius_max + params.mapper.submaps.submap_size
        if reach > half:
            warnings.warn(
                f"submap_size + crop radius = {reach:.1f} m exceeds the voxel "
                f"table's addressable half-extent {half:.1f} m; scans near a "
                f"submap's rollover boundary may truncate (watch "
                f"MapperStats.map_voxels_dropped)", stacklevel=3)

    # -- external pose interface ----------------------------------------------

    def set_map_to_range_sensor(self, T: np.ndarray) -> None:
        with self._lock:
            self.flush()
            self.map_to_range_sensor = np.asarray(T, dtype=np.float32).copy()
            self.is_new_value_set = True

    def loop_closure_update(self, correction: np.ndarray) -> None:
        """≙ Mapper::loopClosureUpdate (Mapper.cpp:92-95): apply the
        pose-graph correction to the current and previous refined pose."""
        with self._lock:
            self.materialize()
            c = np.asarray(correction, dtype=np.float32)
            self.map_to_range_sensor = c @ self.map_to_range_sensor
            self.map_to_range_sensor_prev = c @ self.map_to_range_sensor_prev
            self.last_insertion_pose = c @ self.last_insertion_pose

    def poll(self) -> None:
        """Online idle tick: dispatch the partial block once the device
        pipeline is empty (pose freshness when the stream pauses)."""
        with self._cv:
            if self._queue and not self._inflight:
                self._dispatch_block()

    # -- async state management -----------------------------------------------

    def _ensure_state(self) -> None:
        if self._state is None:
            self._state = pipeline.make_state(self.submaps.active_submap.map,
                                              self.map_to_range_sensor,
                                              self.last_insertion_pose)

    def materialize(self) -> None:
        """Flush in-flight steps and hand map ownership back to the active
        submap (call before any external read of its table)."""
        with self._lock:
            self.flush()
            if self._state is not None:
                self.submaps.active_submap.map = self._state.map
                self._state = None

    def _dispatch_block(self) -> None:
        """Stack the queued scans into one lag-K block, enqueue it, and start
        the non-blocking copies of its small readback tensors.  Blocks are
        1 (single-scan path) or K scans; partial blocks pad with empty
        scans."""
        items = self._queue
        if not items:
            return
        with timing.span("mapper/dispatch", launches=cuda_nn.launch_count):
            self._queue = []
            if self._reader is None:
                self._reader = threading.Thread(target=self._reader_loop,
                                                name="mapper-readback", daemon=True)
                self._reader.start()
            K, n = self.readback_lag, len(items)
            scans = [q.scan for q in items]
            motions = [q.motion for q in items]
            ens = [q.insert_enable for q in items]
            if 1 < n < K:
                if self._pad_scan is None:
                    self._pad_scan = _make_pad_scan(items[0].scan)
                scans += [self._pad_scan] * (K - n)
                motions += [np.eye(4, dtype=np.float32)] * (K - n)
                ens += [False] * (K - n)
            sb = stack(scans)
            db = to_device(np.stack(motions), self.device)
            eb = to_device(np.asarray(ens), self.device, dtype=torch.bool)
            self._ensure_state()
            block_fn = (pipeline.mapper_step_block_shared_ref
                        if (self.pipe_cfg.shared_block_reference and len(scans) > 1)
                        else pipeline.mapper_step_block)
            self._state, outs = block_fn(self._state, sb, db, eb, self.pipe_cfg)
            back = [outs.pose, outs.res.match_ratio, outs.inserted, outs.map_count,
                    outs.dropped]
            if timing.active():
                # The trips that moved the pose: read with the block, no wait of its own.
                back.append(outs.res.iterations)
            readback = HostCopy(back)
            self._inflight.append(_InflightBlock(items=items, outs=outs, readback=readback))
            self._cv.notify_all()

    def _reader_loop(self) -> None:
        """Wait for each in-flight block's readback IN ORDER (outside the
        lock), then run its bookkeeping under the lock.  Only this thread
        pops ``_inflight``.  The wait sits inside the exception guard: a
        dead reader would hang every ``flush()``."""
        while True:
            with self._cv:
                while not self._inflight:
                    self._cv.wait(timeout=0.5)
                blk = self._inflight[0]
            timing.set_scan(blk.items[0].scan_id)
            vals = None
            try:
                with timing.span("mapper/readback_wait"):
                    vals = blk.readback.wait()
            except Exception:  # noqa: BLE001 — keep draining; report loudly
                traceback.print_exc()
            with self._cv:
                self._inflight.popleft()
                try:
                    with timing.span("mapper/bookkeeping"):
                        if vals is not None and self._process_block(blk, vals):
                            self._rebuild_after_rollover()
                except Exception:  # noqa: BLE001 — same as above
                    traceback.print_exc()
                finally:
                    self._cv.notify_all()

    def _rebuild_after_rollover(self) -> None:
        """A processed block rolled the submap over: rebuild the chained
        state from the fresh active submap now (pose = the last dispatched
        scan's odometry extrapolation), and tag every block still in flight
        as tail — their records re-fuse into the fresh chain when their
        readbacks land."""
        with timing.span("mapper/rollover_rebuild"):
            chain_pose = self.map_to_range_sensor.astype(np.float64)
            for blk in self._inflight:
                for q in blk.items:
                    chain_pose = chain_pose @ q.motion.astype(np.float64)
            self._state = pipeline.make_state(self.submaps.active_submap.map,
                                              chain_pose.astype(np.float32),
                                              self.last_insertion_pose)
        for blk in self._inflight:
            blk.tail = True

    def _process_block(self, blk: _InflightBlock, vals) -> bool:
        """Host bookkeeping for one block: pose/trajectory buffers, fitness
        stats, submap rollover, overflow eviction.  Returns True if a record
        rolled the submap over (the caller rebuilds the chain)."""
        new_roll = False
        rolled = blk.tail
        poses, matches, inserteds, mcounts, droppeds = vals[:5]
        if len(vals) > 5:
            timing.count("mapper/icp_trips_active", int(vals[5].sum()))
        self._count_first_scan_trips()
        ml = self.params.mapper.mapper_localizer
        sc = self.submaps
        block_drops = 0
        tail_mask = np.zeros(len(blk.items), dtype=bool)
        for k, q in enumerate(blk.items):
            pose = poses[k].astype(np.float32)
            best_guess = (self.map_to_range_sensor_prev @ q.motion).astype(np.float32)
            self.map_to_range_sensor = pose
            self.map_to_range_sensor_prev = pose.copy()
            self.map_to_range_sensor_buffer.push(q.time, pose)
            self.best_guess_buffer.push(q.time, best_guess)
            fitness = float(matches[k])
            if (not ml.ignore_minimum_refinement_fitness
                    and fitness < ml.scan_to_map_registration.min_refinement_fitness):
                self.stats.scans_rejected_low_fitness += 1
            # Monotone drop accounting: the counter is cumulative per table
            # and restarts on every table swap.
            d = int(droppeds[k])
            delta = d - self._dropped_seen
            if delta < 0:
                delta = d
            if delta > 0:
                self.stats.map_voxels_dropped += delta
                block_drops += delta
            self._dropped_seen = d
            merged_thunk = (lambda o=blk.outs.merged, kk=k: o.map(lambda t: t[kk]))
            if bool(inserteds[k]):
                if not rolled:
                    sc.active_submap.map = self._state.map
                    with timing.span("mapper/post_insert"):
                        changed = sc.post_insert_update(merged_thunk, pose, q.time,
                                                        active_count=int(mcounts[k]))
                    if changed:
                        rolled = True
                        new_roll = True
                    elif sc.active_submap.map is not self._state.map:
                        # Carving replaced the table: it ran on the chain-end
                        # table, so it becomes the chained state and nothing
                        # dispatched is lost.
                        self._state = pipeline.MapState(
                            map=sc.active_submap.map, pose=self._state.pose,
                            last_insertion_pose=self._state.last_insertion_pose)
                else:
                    # Records behind a rollover: their device fusion landed
                    # in the closed submap; re-fuse them into the fresh one.
                    if blk.tail and not new_roll:
                        sc.overlap_buffer.append((merged_thunk, pose, q.time))
                        sc.active_submap.n_scans += 1
                        sc.num_scans_merged_in_active += 1
                        tail_mask[k] = True
                    else:
                        sc.insert_scan(merged_thunk, pose, q.time)
                self.last_insertion_pose = pose.copy()
                self.stats.insertions += 1
            self._finalize(Finalized(time=q.time, pose=pose, merged=merged_thunk,
                                     raw=q.scan, fitness=fitness,
                                     inserted=bool(inserteds[k])))
        if tail_mask.any():
            # One insert for all of this block's post-rollover records, then
            # one lifecycle re-check at the last record's pose.
            rec_mask = np.zeros(blk.outs.merged.mask.shape[0], dtype=bool)
            rec_mask[:len(tail_mask)] = tail_mask
            self._state = pipeline.chain_insert_block(
                self._state, blk.outs.merged,
                to_device(rec_mask, self.device, dtype=torch.bool),
                self.pipe_cfg.map_voxel_size)
            sc.active_submap.map = self._state.map
            last_k = int(np.nonzero(tail_mask)[0][-1])
            if sc.lifecycle_check(poses[last_k].astype(np.float32),
                                  blk.items[last_k].time, active_count=0):
                new_roll = True
        mb = self.params.mapper.map_builder
        if block_drops > 0 and mb.is_overflow_eviction_enabled and not rolled:
            # Overflow policy: this block dropped voxels — evict a fraction of
            # the chain-end table so later scans land.
            with timing.span("mapper/evict"):
                if mb.overflow_evict_policy == "weight":
                    evicted = vm.evict_low_weight(
                        self._state.map, keep_fraction=mb.overflow_evict_keep_fraction)
                else:
                    evicted = vm.evict_far(
                        self._state.map, to_device(self.map_to_range_sensor[:3, 3], self.device),
                        keep_fraction=mb.overflow_evict_keep_fraction)
            self._state = pipeline.MapState(map=evicted, pose=self._state.pose,
                                            last_insertion_pose=self._state.last_insertion_pose)
        return new_roll

    def _count_first_scan_trips(self) -> None:
        while self._first_scan_trips and self._first_scan_trips[0].ready():
            timing.count("mapper/icp_trips_active",
                         int(self._first_scan_trips.pop(0).wait()[0]))

    @timing.traced("mapper")
    def flush(self) -> None:
        """Dispatch any partial block and block until the reader thread has
        drained every in-flight block's bookkeeping."""
        with self._cv:
            self._dispatch_block()
            with timing.span("mapper/flush_wait"):
                while self._inflight:
                    self._cv.wait(timeout=0.5)

    def _finalize(self, rec: Finalized) -> None:
        """Append a per-scan record, evicting (and counting) past the cap."""
        self.finalized.append(rec)
        while len(self.finalized) > self.finalized_cap:
            old = self.finalized.popleft()
            old.merged = None
            old.raw = None
            self.stats.finalized_evicted += 1

    def drain_finalized(self) -> List[Finalized]:
        with self._lock:
            out = list(self.finalized)
            self.finalized.clear()
        return out

    # -- the hot path ---------------------------------------------------------

    @timing.traced("mapper")
    def add_range_measurement(self, raw_scan: PointCloud, time: float) -> bool:
        """≙ Mapper::addRangeMeasurement (Mapper.cpp:168-505).  Enqueues the
        scan and returns without waiting for the device; host bookkeeping
        runs on lag-block readbacks (reader thread, ``flush``)."""
        with self._lock:
            return self._add_range_measurement(raw_scan.to(self.device), time)

    def _add_range_measurement(self, raw_scan: PointCloud, time: float) -> bool:
        ml = self.params.mapper.mapper_localizer

        # First scan: insert directly at the current pose.
        if self.submaps.empty() or self.submaps.active_submap.is_empty():
            self.submaps.ensure_active(self.map_to_range_sensor, time)
            self._ensure_state()
            self._state, out = pipeline.mapper_step(
                self._state, raw_scan, to_device(self.map_to_range_sensor, self.device),
                self.pipe_cfg, True)
            if timing.active():
                # Counted with the next block's readback, which follows it.
                self._first_scan_trips.append(HostCopy([out.res.iterations]))
            self.submaps.note_fused_insert()
            self.map_to_range_sensor_prev = self.map_to_range_sensor.copy()
            self.map_to_range_sensor_buffer.push(time, self.map_to_range_sensor)
            self.best_guess_buffer.push(time, self.map_to_range_sensor)
            self.last_insertion_pose = self.map_to_range_sensor.copy()
            self.last_measurement_time = time
            self.init_time = time
            self.is_new_value_set = False
            self.stats.scans_processed += 1
            self.stats.insertions += 1
            self._finalize(Finalized(time=time, pose=self.map_to_range_sensor.copy(),
                                     merged=(lambda o=out.merged: o), raw=raw_scan,
                                     inserted=True))
            return True

        # Out-of-order: propagate by last odometry motion (Mapper.cpp:196-235).
        if self.last_measurement_time is not None and time <= self.last_measurement_time:
            self.flush()
            self.stats.out_of_order += 1
            if len(self.odom_buffer) >= 2:
                t_latest = self.odom_buffer.latest_time()
                delta = self.odom_buffer.relative_motion(self.last_measurement_time, t_latest)
                backup = self.map_to_range_sensor_prev @ delta
                self.map_to_range_sensor = backup.astype(np.float32)
                self.map_to_range_sensor_buffer.push(t_latest, self.map_to_range_sensor)
                self.best_guess_buffer.push(t_latest, self.map_to_range_sensor_prev)
                self.map_to_range_sensor_prev = self.map_to_range_sensor.copy()
            self._finalize(Finalized(time=time, pose=self.map_to_range_sensor.copy(),
                                     merged=None, raw=raw_scan))
            return True

        # Odometry motion delta for the on-device initial guess (:265-300).
        motion = np.eye(4, dtype=np.float32)
        if not self.odom_buffer.empty and not self.is_new_value_set:
            calib_inv = np.linalg.inv(self.calibration)
            odom_now = self.odom_buffer.get_transform(time) @ calib_inv
            odom_prev = self.odom_buffer.get_transform(
                self.last_measurement_time if self.last_measurement_time is not None
                else time) @ calib_inv
            motion = (np.linalg.inv(odom_prev) @ odom_now).astype(np.float32)

        if self.is_new_value_set:
            # External pose was just set; trust it, skip refinement.
            if self._state is not None:
                self._state = pipeline.make_state(self._state.map, self.map_to_range_sensor,
                                                  self.last_insertion_pose)
            self.map_to_range_sensor_prev = self.map_to_range_sensor.copy()
            self.map_to_range_sensor_buffer.push(time, self.map_to_range_sensor)
            self.best_guess_buffer.push(time, self.map_to_range_sensor)
            self.is_new_value_set = False
            self.init_time = time
            self.last_measurement_time = time
            self._finalize(Finalized(time=time, pose=self.map_to_range_sensor.copy(),
                                     merged=None, raw=raw_scan))
            return True

        # Localization mode: suppress merging (Mapper.cpp:466-479).
        merge_suppressed = (
            (self.is_use_initial_map and not self.is_merge_scans_into_map)
            or (self.is_use_initial_map and self.is_merge_scans_into_map
                and self.init_time is not None
                and (time - self.init_time) < ml.map_merge_delay_in_seconds))
        self._queue.append(_QueuedScan(time=time, scan=raw_scan, motion=motion,
                                       insert_enable=not merge_suppressed,
                                       scan_id=timing.current_scan()))
        self.last_measurement_time = time
        self.stats.scans_processed += 1
        if len(self._queue) >= self.readback_lag:
            self._dispatch_block()
            # Backpressure only: wait when the device is a full window behind.
            while len(self._inflight) >= self.max_inflight_blocks:
                self._cv.wait(timeout=0.5)
        return True

    def get_assembled_map(self) -> PointCloud:
        """≙ getAssembledMapPointCloud (Mapper.cpp:506-538)."""
        self.materialize()
        clouds = [s.map.cloud for s in self.submaps.submaps]
        if not clouds:
            return empty_cloud(1, device=self.device)
        out = clouds[0]
        for c in clouds[1:]:
            out = concatenate(out, c)
        return out
