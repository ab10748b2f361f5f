"""Fixed-capacity masked point clouds — the core tensor type of the port.

Counterpart of the JAX package's ``utils/pointcloud.py``: every cloud
carries a fixed capacity ``N`` plus a validity mask; the "size" of a cloud
is ``mask.sum()``.  Invalid lanes hold a far-away sentinel position so that
they never participate in neighbor searches.  Fixed shapes keep the hot
path free of host synchronisations (a boolean-mask select would read the
count back to the host).

All methods accept leading batch dimensions (``[..., N, 3]``): the JAX
package ``vmap``s over the K scans of a lag block, the port writes that
batch dimension out.

Descriptor channels (≙ DataPoints descriptors beyond normals: intensity,
per-point time, colors; reference PointMatcher.h:327-409) live in one
``attrs`` block f32[..., N, C] with a tuple of channel names, as in the JAX
package: every gather, mask and segment sum carries all channels at once,
and invalid lanes hold zeros.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

Tensor = torch.Tensor

# Sentinel coordinate for invalid points: far outside any plausible map so it
# can never be a nearest neighbor or land in a real voxel.
SENTINEL = 1.0e8


def gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """Rows of ``x`` [..., N, C] at ``idx`` [..., M] (or [M], shared across
    the batch)."""
    i = idx.expand(x.shape[:-2] + idx.shape[-1:])
    return torch.gather(x, -2, i.unsqueeze(-1).expand(i.shape + x.shape[-1:]))


def gather_lanes(x: Tensor, idx: Tensor) -> Tensor:
    """Lanes of ``x`` [..., N] at ``idx`` [..., M] (or [M])."""
    return torch.gather(x, -1, idx.expand(x.shape[:-1] + idx.shape[-1:]))


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """SoA point cloud with a fixed capacity and validity mask.

    xyz:        f32[..., N, 3]  positions (invalid lanes = SENTINEL)
    normals:    f32[..., N, 3]  unit normals (zeros when absent/invalid)
    mask:       bool[..., N]    lane validity
    attrs:      f32[..., N, C]  optional descriptor channels
    attr_names: channel names for ``attrs`` columns
    """

    xyz: Tensor
    normals: Tensor
    mask: Tensor
    attrs: Optional[Tensor] = None
    attr_names: Tuple[str, ...] = ()

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def count(self) -> Tensor:
        return self.mask.sum(-1, dtype=torch.int32)

    @property
    def has_normals(self) -> bool:
        """True for every cloud, as in the JAX package (``normals is not
        None``): absent normals are zeros, and the PointCloud2 writer sends
        them all the same."""
        return self.normals is not None

    def map(self, fn) -> "PointCloud":
        """Apply ``fn`` to every tensor field (the pytree map of the JAX
        package: slicing, stacking helpers, device moves)."""
        return dataclasses.replace(
            self, xyz=fn(self.xyz), normals=fn(self.normals), mask=fn(self.mask),
            attrs=None if self.attrs is None else fn(self.attrs))

    def to(self, device) -> "PointCloud":
        return self.map(lambda t: t.to(device))

    # -- descriptor channels ------------------------------------------------
    def has_attr(self, name: str) -> bool:
        return self.attrs is not None and name in self.attr_names

    def attr(self, name: str) -> Tensor:
        """One channel as f32[..., N] (≙ DataPoints::getDescriptorViewByName)."""
        if not self.has_attr(name):
            raise KeyError(f"no attr {name!r}; have {self.attr_names}")
        return self.attrs[..., self.attr_names.index(name)]

    def with_attr(self, name: str, values: Tensor) -> "PointCloud":
        """Add or replace one descriptor channel (≙ DataPoints::addDescriptor);
        zeros on invalid lanes."""
        col = torch.where(self.mask, values.to(torch.float32), 0.0)[..., None]
        if self.attrs is None:
            return dataclasses.replace(self, attrs=col, attr_names=(name,))
        if name in self.attr_names:
            i = self.attr_names.index(name)
            attrs = torch.cat([self.attrs[..., :i], col, self.attrs[..., i + 1:]], dim=-1)
            return dataclasses.replace(self, attrs=attrs)
        return dataclasses.replace(self, attrs=torch.cat([self.attrs, col], dim=-1),
                                   attr_names=self.attr_names + (name,))

    def without_attrs(self) -> "PointCloud":
        return dataclasses.replace(self, attrs=None, attr_names=())

    def select(self, names: Tuple[str, ...]) -> "PointCloud":
        """Keep the channels ``names``, in that order."""
        if not names:
            return self.without_attrs()
        attrs = torch.stack([self.attr(k) for k in names], dim=-1)
        return dataclasses.replace(self, attrs=attrs, attr_names=tuple(names))

    def with_xyz(self, xyz: Tensor) -> "PointCloud":
        return dataclasses.replace(
            self, xyz=torch.where(self.mask[..., None], xyz, SENTINEL))

    def with_normals(self, normals: Tensor) -> "PointCloud":
        return dataclasses.replace(
            self, normals=torch.where(self.mask[..., None], normals, 0.0))

    def with_mask(self, mask: Tensor) -> "PointCloud":
        """Apply a (sub)mask; invalid lanes are pushed to the sentinel."""
        m = self.mask & mask
        return dataclasses.replace(
            self,
            xyz=torch.where(m[..., None], self.xyz, SENTINEL),
            normals=torch.where(m[..., None], self.normals, 0.0),
            mask=m,
            attrs=None if self.attrs is None
            else torch.where(m[..., None], self.attrs, 0.0),
        )

    def take(self, idx: Tensor, valid: Optional[Tensor] = None) -> "PointCloud":
        """Gather lanes by index (per batch row when ``idx`` is batched);
        ``valid`` additionally masks the gathered lanes."""
        m = gather_lanes(self.mask, idx)
        if valid is not None:
            m = m & valid
        return dataclasses.replace(
            self,
            xyz=torch.where(m[..., None], gather_rows(self.xyz, idx), SENTINEL),
            normals=torch.where(m[..., None], gather_rows(self.normals, idx), 0.0),
            mask=m,
            attrs=None if self.attrs is None
            else torch.where(m[..., None], gather_rows(self.attrs, idx), 0.0),
        )

    def transform(self, T: Tensor) -> "PointCloud":
        """Rigid transform of points and normals (masked lanes stay
        sentinel; descriptor channels are frame-independent and carried
        through).  ``T`` is [4, 4] or batched like the cloud [..., 4, 4]."""
        from . import se3

        return dataclasses.replace(
            self,
            xyz=torch.where(self.mask[..., None], se3.apply(T, self.xyz), SENTINEL),
            normals=torch.where(self.mask[..., None], se3.rotate(T, self.normals), 0.0),
        )


def stack(clouds) -> PointCloud:
    """Stack same-shaped clouds on a new leading axis."""
    c0 = clouds[0]
    return PointCloud(
        xyz=torch.stack([c.xyz for c in clouds]),
        normals=torch.stack([c.normals for c in clouds]),
        mask=torch.stack([c.mask for c in clouds]),
        attrs=None if c0.attrs is None else torch.stack([c.attrs for c in clouds]),
        attr_names=c0.attr_names)


def make_cloud(xyz, normals=None, mask=None, capacity: Optional[int] = None,
               device=None, attrs: Optional[Dict[str, object]] = None) -> PointCloud:
    """Build a PointCloud from host or device arrays, padding to capacity.
    ``device`` defaults to the device of ``xyz`` when it is a tensor, else
    ``cuda``.  Host arrays go up through pinned memory without a stream
    synchronisation (``device.to_device``).  ``attrs`` maps channel name ->
    f32[N] column."""
    from .device import to_device

    if device is None:
        device = xyz.device if isinstance(xyz, Tensor) else "cuda"
    xyz = to_device(xyz, device)
    n = xyz.shape[0]
    capacity = n if capacity is None else capacity
    if capacity < n:
        raise ValueError(f"capacity {capacity} < points {n}")
    normals = torch.zeros_like(xyz) if normals is None else to_device(normals, device)
    mask = (torch.ones((n,), dtype=torch.bool, device=device) if mask is None
            else to_device(mask, device, dtype=torch.bool))
    attr_names: Tuple[str, ...] = tuple(attrs) if attrs else ()
    block = None
    if attr_names:
        block = torch.stack([to_device(attrs[k], device).reshape(n) for k in attr_names], -1)
    pad = capacity - n
    if pad:
        xyz = torch.cat([xyz, xyz.new_full((pad, 3), SENTINEL)])
        normals = torch.cat([normals, normals.new_zeros((pad, 3))])
        mask = torch.cat([mask, mask.new_zeros((pad,))])
        if block is not None:
            block = torch.cat([block, block.new_zeros((pad, block.shape[-1]))])
    return PointCloud(xyz=torch.where(mask[:, None], xyz, SENTINEL),
                      normals=torch.where(mask[:, None], normals, 0.0), mask=mask,
                      attrs=None if block is None else torch.where(mask[:, None], block, 0.0),
                      attr_names=attr_names)


def empty_cloud(capacity: int, device="cuda", attr_names: Tuple[str, ...] = ()) -> PointCloud:
    return PointCloud(
        xyz=torch.full((capacity, 3), SENTINEL, dtype=torch.float32, device=device),
        normals=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        attrs=(torch.zeros((capacity, len(attr_names)), dtype=torch.float32, device=device)
               if attr_names else None),
        attr_names=tuple(attr_names))


def compact(cloud: PointCloud, capacity: int) -> PointCloud:
    """Pack valid points to the front and truncate/pad to ``capacity``.
    Stable order: preserves the relative order of valid points."""
    n = cloud.capacity
    order = torch.argsort((~cloud.mask).to(torch.int8), dim=-1, stable=True)
    if capacity <= n:
        return cloud.take(order[..., :capacity])
    lead = order.shape[:-1]
    take = torch.cat([order, order.new_zeros(lead + (capacity - n,))], dim=-1)
    valid = torch.arange(capacity, device=order.device) < n
    return cloud.take(take, valid)


def _align_attrs(a: PointCloud, b: PointCloud) -> Tuple[PointCloud, PointCloud]:
    """Restrict both clouds to their common descriptor channels (ordered as
    in ``a``) so that concatenation is well defined."""
    if a.attrs is None or b.attrs is None:
        return a.without_attrs(), b.without_attrs()
    if a.attr_names == b.attr_names:
        return a, b
    common = tuple(k for k in a.attr_names if k in b.attr_names)
    return a.select(common), b.select(common)


def concatenate(a: PointCloud, b: PointCloud, capacity: Optional[int] = None) -> PointCloud:
    cap = capacity if capacity is not None else a.capacity + b.capacity
    a, b = _align_attrs(a, b)
    merged = PointCloud(
        xyz=torch.cat([a.xyz, b.xyz], dim=-2),
        normals=torch.cat([a.normals, b.normals], dim=-2),
        mask=torch.cat([a.mask, b.mask], dim=-1),
        attrs=None if a.attrs is None else torch.cat([a.attrs, b.attrs], dim=-2),
        attr_names=a.attr_names)
    return compact(merged, cap)


def to_numpy(cloud: PointCloud):
    """The valid points as host numpy arrays (xyz, normals): a host-only
    view of dynamic size."""
    mask = cloud.mask.cpu().numpy()
    return cloud.xyz.cpu().numpy()[mask], cloud.normals.cpu().numpy()[mask]

