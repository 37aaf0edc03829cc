"""Multi-process PGZF: member slabs over a ``torch.distributed`` group
(counterpart of ``libflate_tpu/parallel/multihost.py:32-134``).

* **Slab partition**: the input is split into one slab a process on
  ``member_size`` boundaries, so every gzip member belongs to one
  process (members are independent; no halo).
* **Local work**: each process runs ``pgzf`` on its slab, on its own
  device ``cuda:{rank % device_count}`` (``device="cuda"``), on the host
  (``device="cpu"``) or on a named host engine.
* **Ordered gather**: the variable-length results travel as CPU tensors
  over gloo (lengths first, then the padded bytes) and are joined in rank
  order.  No CUDA tensor enters a collective, so no NCCL communicator is
  made and two ranks may share one card.
* **Checksum folding**: the slabs' CRCs fold with ``crc32_combine``; no
  process reads bytes outside its slab.

With the native engine, or with slabs of a multiple of 128 members, the
stream equals one process's ``pgzf.compress`` byte for byte.  The device
route shares one code table between the 128 members of a batch
(``pgzf.DEV_BATCH``): a slab boundary inside a batch gives other tables
and other bytes, which decode to the same plaintext.

Without an initialised group every function runs as one process, and the
gather returns its own part.
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats import pgzf
from ..utils.checksum import crc32_combine


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int) -> None:
    """Join the process group at ``host:port`` (once a process): gloo for
    CPU tensors, and NCCL for CUDA tensors where torch has it.  With CUDA
    the process's current device becomes ``cuda:{rank % device_count}``."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    backend = ("cpu:gloo,cuda:nccl" if dist.is_nccl_available()
               else "gloo")
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _process_info() -> tuple[int, int]:
    """(rank, world size) of the initialised group, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _device(device, engine: str | None):
    """The device the device route of ``engine`` runs on: ``device``, with
    "cuda" without an index taken as this rank's card; ``device`` as given
    for a host engine, which does not read it."""
    if engine not in (None, "auto"):
        return device
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        from .. import require_cuda
        require_cuda()
        rank, _n = _process_info()
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def slab_bounds(total: int, member_size: int, pid: int, n: int
                ) -> tuple[int, int]:
    """Contiguous per-process slab, aligned to member boundaries."""
    n_members = max(1, -(-total // member_size))
    per = -(-n_members // n)
    lo = min(pid * per * member_size, total)
    hi = min((pid + 1) * per * member_size, total)
    return lo, hi


def _allgather_bytes(local: bytes) -> list[bytes]:
    """Ordered gather of one variable-length byte string per process."""
    pid, n = _process_info()
    if n == 1:
        return [local]
    import torch.distributed as dist

    lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lengths, torch.tensor([len(local)], dtype=torch.int64))
    lengths = [int(t[0]) for t in lengths]
    pad = max(max(lengths), 1)
    buf = torch.zeros(pad, dtype=torch.uint8)
    buf[:len(local)] = torch.frombuffer(bytearray(local), dtype=torch.uint8)
    gathered = [torch.empty(pad, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(gathered, buf)
    return [g[:ln].numpy().tobytes() for g, ln in zip(gathered, lengths)]


def compress_multihost(data: bytes,
                       member_size: int = pgzf.DEFAULT_MEMBER_SIZE,
                       device="cuda", engine: str | None = None,
                       n_threads: int = 0) -> bytes:
    """Member-sharded encode across the group's processes.

    Every process receives the full ``data`` (a shared file system, say),
    compresses only its slab with ``pgzf.compress(..., device=device,
    engine=engine, n_threads=n_threads)``, and the ordered gather returns
    the complete stream on every process: one process's stream byte for
    byte where the slabs keep the 128-member batches of the device route
    whole, or with the native engine (see the module's docstring).
    """
    pid, n = _process_info()
    lo, hi = slab_bounds(len(data), member_size, pid, n)
    local = (pgzf.compress(data[lo:hi], member_size=member_size,
                           device=_device(device, engine), engine=engine,
                           n_threads=n_threads)
             if hi > lo else b"")
    return b"".join(_allgather_bytes(local))


def decompress_multihost(stream: bytes, device="cuda",
                         engine: str | None = None,
                         n_threads: int = 0) -> bytes:
    """Member-sharded decode: each process decodes a contiguous run of
    members with ``pgzf.decompress``; the ordered gather reassembles the
    plaintext.  A stream without the LF index is decoded whole on every
    process, as in the reference."""
    pid, n = _process_info()
    dev = _device(device, engine)
    refs = pgzf.index_members(stream)
    if refs is None:
        # no member boundaries without decoding: every process decodes
        # the whole stream
        return pgzf.decompress(stream, device=dev, engine=engine,
                               n_threads=n_threads)
    per = -(-len(refs) // n)
    mine = refs[pid * per:(pid + 1) * per]
    local = b""
    if mine:
        piece = stream[mine[0].start:mine[-1].end]
        local = pgzf.decompress(piece, device=dev, engine=engine,
                                n_threads=n_threads)
    return b"".join(_allgather_bytes(local))


def corpus_crc32_multihost(data: bytes,
                           member_size: int = pgzf.DEFAULT_MEMBER_SIZE,
                           device="cuda", engine: str | None = None) -> int:
    """Whole-corpus CRC-32 from each process's slab CRC (the engine
    ``engine``, else the device engine of ``device``) folded with
    ``crc32_combine``: no process reads bytes outside its slab."""
    from .. import backend
    pid, n = _process_info()
    lo, hi = slab_bounds(len(data), member_size, pid, n)
    eng = backend.get(engine if engine is not None
                      else _device(device, engine).type)
    local_crc = eng.crc32(data[lo:hi]) if hi > lo else 0
    parts = _allgather_bytes(
        np.asarray([local_crc, hi - lo], np.uint64).tobytes())
    crc, total = 0, 0
    for blob in parts:
        c, ln = np.frombuffer(blob, np.uint64)
        crc = crc32_combine(crc, int(c), int(ln)) if total else int(c)
        total += int(ln)
    return crc
