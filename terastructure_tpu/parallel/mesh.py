"""Device mesh construction for the 2-D individuals x SNPs layout.

The reference's only parallelism is pthreads over individual chunks on one
node (SURVEY.md §2, "Threading"). The accelerator design (BASELINE.json
north star) shards:

  - gamma and the exp-Elog-theta factor over the 'ind' axis (hosts),
  - lambda and the packed genotype matrix over the 'snp' axis (the cards
    of one host, joined all to all by NVLink),

so that per-minibatch lambda statistics reduce over 'ind' and the gamma
natural-gradient statistics reduce over 'snp' — both as psum
collectives. The mesh only reshapes the device list: every card of a
host reaches every other at the same rate, so the layout follows the
algorithm alone.

Multi-host entry: call jax.distributed.initialize() before make_mesh();
jax.devices() then spans all hosts and the same code paths apply.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

IND_AXIS = "ind"
SNP_AXIS = "snp"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    ind: int
    snp: int

    @property
    def n_devices(self):
        return self.ind * self.snp


def choose_mesh_shape(n_devices: int, ind: int = 0, snp: int = 0) -> MeshSpec:
    """Pick (ind, snp) axis sizes. Defaults put all devices on 'snp'
    (single-host: the SNP axis is the big one and its psum payload,
    N_local x K, shrinks as 'ind' grows — so 'ind' is reserved for hosts)."""
    if ind and snp:
        if ind * snp != n_devices:
            raise ValueError(f"mesh {ind}x{snp} != {n_devices} devices")
        return MeshSpec(ind, snp)
    if ind:
        return MeshSpec(ind, n_devices // ind)
    if snp:
        return MeshSpec(n_devices // snp, snp)
    return MeshSpec(1, n_devices)


def make_mesh(spec: Optional[MeshSpec] = None, devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if spec is None:
        spec = choose_mesh_shape(len(devices))
    dev_array = np.asarray(devices[: spec.n_devices]).reshape(spec.ind, spec.snp)
    return Mesh(dev_array, (IND_AXIS, SNP_AXIS))


# Canonical PartitionSpecs for every array in the engine.
GAMMA_SPEC = P(IND_AXIS, None)            # (N, K) rows over hosts
LAMB_SPEC = P(SNP_AXIS, None, None)       # (L, K, 2) rows over chips
PACKED_SPEC = P(SNP_AXIS, IND_AXIS)       # (L, W) 2-D sharded genotypes
REPLICATED = P()


def sharding(mesh: Mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)
