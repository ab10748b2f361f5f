"""ICPSequence: registration against a persistent, amortized reference.

Counterpart of the JAX package's ``ops/registration/sequence.py`` (reference
pointmatcher/ICP.cpp:476-630: one filtered reference, the "map", kept
across many ``compute(cloud, guess)`` calls, so that reference filtering
and matcher preparation are paid once, not per scan).

``set_map`` filters the map and prepares the matcher's reference once:
kernel K1's prepared reference (``icp.prepare_reference``) on the map in
Morton order, or the hashed grid for ``matcher="hashgrid"``.  The JAX
package always builds the hashed grid (``sequence.py:49-55``), which needs
a finite maxDist and which its dense matchers read in bucket order: the
port's reference order differs, so only an exact distance tie can pick
another neighbour.
"""
from __future__ import annotations

from typing import Optional

from ...utils.device import to_device
from ...utils.pointcloud import PointCloud
from .. import hashgrid
from . import chain as chain_mod
from . import icp
from .icp import ICPConfig, ICPResult


class ICPSequence:
    """Persistent-reference ICP (≙ PM::ICPSequence).

    >>> seq = ICPSequence(cfg)
    >>> seq.set_map(map_patch)          # ≙ setMap: filter + prepare once
    >>> res = seq.compute(scan, T_init)  # ≙ operator()(cloud, guess)
    """

    def __init__(self, cfg: ICPConfig = ICPConfig(), chain: Optional["chain_mod.IcpChain"] = None,
                 table_size: int = 1 << 14):
        # ``chain``: an IcpChain whose reference pipeline set_map applies and
        # whose reading pipeline compute applies.
        self.cfg = chain.config if chain is not None else cfg
        self.chain = chain
        self.table_size = table_size
        self._grid: Optional[hashgrid.HashGrid] = None
        self._nn_ref = None

    def has_map(self) -> bool:
        """≙ ICPSequence::hasMap."""
        return self._grid is not None

    def set_map(self, cloud: PointCloud, seed: int = 0) -> None:
        """Filter the map cloud (with a chain) and prepare the matcher's
        reference once (≙ ICPSequence::setMap / initReference)."""
        desc = None
        if self.chain is not None:
            cloud = self.chain.process_reference(cloud, seed)
            desc = self.chain.ref_desc_channel
        self._grid = chain_mod.reference_grid(cloud, self.cfg, desc, self.table_size)
        self._nn_ref = icp.prepare_reference(self.cfg, self._grid)

    def clear_map(self) -> None:
        """≙ ICPSequence::clearMap."""
        self._grid = self._nn_ref = None

    @property
    def map_grid(self) -> hashgrid.HashGrid:
        if self._grid is None:
            raise RuntimeError("ICPSequence: no map set (call set_map first)")
        return self._grid

    def compute(self, reading: PointCloud, init_T, seed: int = 0) -> ICPResult:
        """Register a scan against the persistent map.  The loop polls its
        done flag and stops dispatching at convergence (the caller reads
        the result)."""
        grid = self.map_grid
        if self.chain is not None:
            reading = self.chain.process_reading(reading, seed)
        reading = chain_mod.kernel_order(reading, self.cfg)
        return icp.register(reading, grid, to_device(init_T, reading.device), self.cfg,
                            nn_ref=self._nn_ref, poll_every=icp.POLL_EVERY)

    __call__ = compute
