"""A device mesh and the cross-shard collectives of the multi-chip prover.

Counterpart of `zkvm_tpu/ops/collective.py`.  The reference is one
controller: one Python process synthesises the witness, runs the transcript
and drives `shard_map` programs over every device of a `jax.sharding.Mesh`.
The port does the same in one process.  A `Mesh` is a tuple of torch
devices, and the same device may appear more than once, as logical shards:
a mesh of four shards on one card runs every sharded code path; on a
machine with several cards the same code copies between them.

Each sharded operation takes global tensors on the mesh's home device
(`devices[0]`), splits them into shards itself (`Mesh.split`), runs each
shard's step on that shard's device and gathers the result
(`Mesh.gather`).  Data moves only through explicit
`Tensor.to(device, non_blocking=True)` copies.  Where two shards share a
device that copy returns the tensor itself, so every shard step is out of
place: it never writes to its input.

The grand-product accumulator (plonk/src/composer/permutation.rs:181-245)
is a prefix product over the full domain; sharded, it becomes local scans
plus an exchange of one edge element per shard:

    prefix_i = local_prefix_i * prod(shard totals left of my shard)
"""

from __future__ import annotations

import torch

from . import limb_field as lf
from .limb_field import FR


def resolve_device(device) -> torch.device:
    """`device` with its index ("cuda" -> "cuda:<current>"); raises for a
    device this machine does not have."""
    return torch.empty(0, device=device).device


class Mesh:
    """An ordered tuple of devices along one named axis (the reference's
    one-axis `jax.sharding.Mesh`).  Nothing here probes the machine: the
    mesh is the devices the caller names, and a device that does not exist
    raises here."""

    def __init__(self, devices, axis_names=("shards",)):
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh spans one kind of device, not "
                             f"{sorted({d.type for d in devs})}")
        if len(axis_names) != 1:
            raise ValueError(f"a mesh has one axis, not {axis_names}")
        self.devices = devs
        self.axis_names = tuple(axis_names)
        self.size = len(devs)

    @property
    def home(self) -> torch.device:
        """Where global tensors live."""
        return self.devices[0]

    def axis(self, axis: str | None = None) -> str:
        """The mesh's axis; `axis`, where given, must name it."""
        if axis is not None and axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} is not the mesh's "
                             f"{self.axis_names[0]!r}")
        return self.axis_names[0]

    def _key(self):
        return self.devices, self.axis_names

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.axis_names})")

    # ---- data movement: explicit copies, nothing else ------------------------
    def _chunks(self, x: torch.Tensor, dim: int):
        if x.shape[dim] % self.size:
            raise ValueError(f"axis {dim} of {tuple(x.shape)} does not split "
                             f"into {self.size} shards")
        return x.chunk(self.size, dim)

    def split(self, x: torch.Tensor, dim: int = -1) -> list[torch.Tensor]:
        """A global tensor -> one equal part along `dim` per shard, each on
        its shard's device (a view where that is the tensor's device)."""
        return [part.to(dev, non_blocking=True)
                for part, dev in zip(self._chunks(x, dim), self.devices)]

    def gather(self, parts, dim: int = -1) -> torch.Tensor:
        """One part per shard -> their concatenation along `dim` on the home
        device."""
        return torch.cat([p.to(self.home, non_blocking=True) for p in parts],
                         dim)

    def all_gather(self, parts) -> list[torch.Tensor]:
        """One tensor per shard -> on every shard, the [D, ...] stack of all
        of them in shard order (`jax.lax.all_gather`)."""
        return [torch.stack([p.to(dev, non_blocking=True) for p in parts])
                for dev in self.devices]

    def all_to_all(self, parts, split_dim: int,
                   concat_dim: int) -> list[torch.Tensor]:
        """Shard i's part splits along `split_dim` into D chunks; shard j
        gets chunk j of every shard, concatenated along `concat_dim` in
        shard order (`jax.lax.all_to_all(..., tiled=True)`)."""
        chunks = [self._chunks(p, split_dim) for p in parts]
        return [torch.cat([c[j].to(dev, non_blocking=True) for c in chunks],
                          concat_dim)
                for j, dev in enumerate(self.devices)]


def _segment_combine(gathered, my_idx: int, reverse: bool):
    """Product of the other shards' totals on my side (exclusive): those
    left of shard `my_idx`, or right of it when `reverse`; None where there
    is none."""
    acc = None
    for d in range(gathered.shape[0]):
        if (d > my_idx) if reverse else (d < my_idx):
            acc = (gathered[d] if acc is None
                   else lf.mont_mul(FR, acc, gathered[d]))
    return acc


def sharded_scan_mul(x: torch.Tensor, mesh: Mesh,
                     reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix (suffix when `reverse`) Montgomery products over the
    last axis of a global [8, N] tensor, sharded over `mesh`: each shard
    scans its part (`dpoly.prefix_products`), the shards all-gather one
    edge element each, and each multiplies its scan by the product of the
    totals on its side.  Products mod r are exact, so the result equals
    the single-device scan bit for bit."""
    from ..plonk.dpoly import prefix_products  # plonk imports this module

    local = [prefix_products(p, reverse) for p in mesh.split(x)]
    edges = [t[..., :1] if reverse else t[..., -1:] for t in local]
    out = []
    for i, (loc, gathered) in enumerate(zip(local,
                                            mesh.all_gather(edges))):
        off = _segment_combine(gathered, i, reverse)
        out.append(loc if off is None else lf.mont_mul(FR, loc, off))
    return mesh.gather(out)
