"""A one-axis device mesh for block- and member-parallel work (counterpart
of ``libflate_tpu/parallel/mesh.py:18-37``).

DEFLATE blocks and gzip members are independent, so the batch axis is the
one axis to split.  A :class:`Mesh` is an ordered tuple of torch devices
on the ``blocks`` axis; one process drives all of them, as the
reference's one process drives its local devices.  A device may appear
more than once: ``[cuda:0] * 4`` is four logical shards on one card, and
``["cpu"] * 8`` the reference tests' eight-device mesh on the host.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK_AXIS = "blocks"


class Mesh:
    """An ordered tuple of torch devices on the one ``blocks`` axis; each
    entry holds one shard."""

    def __init__(self, devices) -> None:
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("Mesh: needs at least one device")

    @property
    def shape(self) -> dict:
        return {BLOCK_AXIS: len(self.devices)}

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Mesh over ``devices`` (default: every local CUDA device), the first
    ``n_devices`` of them when given.  Raises RuntimeError when CUDA is not
    available and no ``devices`` are given: the host is never taken in the
    card's place."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available (pass "
                               "devices=['cpu'] * n for a host mesh)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices)


class Sharding:
    """How an array's leading axis lies on a mesh: cut into one contiguous
    shard a mesh entry (:func:`block_sharding`), or whole on every entry
    (:func:`replicated`)."""

    def __init__(self, mesh: Mesh, split: bool) -> None:
        self.mesh = mesh
        self.split_axis = split

    def split(self, x) -> list[np.ndarray]:
        """Host pieces of ``x`` (numpy or a tensor), one a mesh entry.
        Raises ValueError when the leading axis is not a multiple of the
        mesh size, where the reference's ``NamedSharding`` refuses."""
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        n = len(self.mesh)
        if not self.split_axis:
            return [x] * n
        if x.ndim == 0 or x.shape[0] % n:
            raise ValueError(f"leading axis of shape {x.shape} is not a "
                             f"multiple of the mesh size {n}")
        return np.split(x, n)

    def shard(self, x) -> list[torch.Tensor]:
        """:meth:`split`, each piece on its mesh device (uint32 words as
        their int32 bit patterns)."""
        out = []
        for piece, dev in zip(self.split(x), self.mesh):
            piece = np.ascontiguousarray(piece)
            if piece.dtype == np.uint32:
                piece = piece.view(np.int32)
            out.append(torch.from_numpy(piece).to(dev))
        return out


def block_sharding(mesh: Mesh) -> Sharding:
    """Split the leading block axis across the mesh."""
    return Sharding(mesh, True)


def replicated(mesh: Mesh) -> Sharding:
    """The whole array on every mesh entry."""
    return Sharding(mesh, False)
