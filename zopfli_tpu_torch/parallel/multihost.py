"""Multi-process compression over torch.distributed.

Port of zopfli_tpu/parallel/multihost.py.  Master blocks are
data-parallel across processes (each sees its 32 KiB halo); per-master
checksums are computed locally and merged with crc32_combine /
adler32_combine; the variable-length, bit-aligned part streams are
gathered IN ORDER on rank 0 (a padded uint8 all-gather) and spliced --
non-final parts end byte-misaligned, which BitStream.extend resolves.

The launcher starts the process group (torch.distributed
.init_process_group with its address, world size and rank; gloo between
CPU processes, or NCCL with each rank's CUDA device made current); then
`zopfli_tpu_torch.compress` routes here by itself.  Without a process
group, or with one process, this runs deflate_part master by master.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from .. import containers, spec
from ..deflate import Options, deflate_part
from ..emit import BitStream


def _masters(insize: int):
    out = []
    i = 0
    while True:
        final = i + spec.MASTER_BLOCK_SIZE >= insize
        size = insize - i if final else spec.MASTER_BLOCK_SIZE
        out.append((i, i + size, final))
        i += size
        if i >= insize:
            break
    return out


def active() -> bool:
    """True inside an initialized torch.distributed group of > 1 process."""
    dist = torch.distributed
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _rank_world() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _comm_device() -> torch.device:
    """Where collectives' tensors live: the current CUDA device under
    NCCL, else the CPU."""
    if torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather_ints(vals: list[int]) -> list[list[int]]:
    """All-gather a few int64s per process, in rank order."""
    dist = torch.distributed
    t = torch.tensor(vals, dtype=torch.int64, device=_comm_device())
    out = [torch.zeros_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return [o.cpu().tolist() for o in out]


def _allgather_bytes(blob: bytes) -> list[bytes]:
    """All-gather one variable-length byte blob per process, in rank
    order: the lengths first, then the blobs padded to the longest."""
    _, world = _rank_world()
    if world == 1:
        return [blob]
    dist = torch.distributed
    dev = _comm_device()
    lens = [v[0] for v in _allgather_ints([len(blob)])]
    buf = torch.zeros(max(lens), dtype=torch.uint8, device=dev)
    buf[:len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    bufs = [torch.zeros_like(buf) for _ in range(world)]
    dist.all_gather(bufs, buf)
    return [b[:k].cpu().numpy().tobytes() for b, k in zip(bufs, lens)]


def compress_multihost(data, fmt: str = "gzip",
                       options: Options | None = None) -> bytes | None:
    """Compress `data` with master blocks sharded over all processes.

    Every process must pass identical `data`: the processes compare its
    length and CRC-32 before any work and all raise ValueError if they
    differ.  Returns the container bytes on rank 0, None elsewhere.
    """
    options = options or Options()
    if fmt not in ("gzip", "zlib", "deflate"):
        raise ValueError(f"unknown format {fmt!r}")
    arr = np.ascontiguousarray(np.frombuffer(bytes(data), dtype=np.uint8)
                               if not isinstance(data, np.ndarray) else data)
    rank, world = _rank_world()
    if world > 1:
        seen = _allgather_ints([len(arr), containers.crc32(arr)])
        if any(v != seen[0] for v in seen):
            raise ValueError(f"compress_multihost: the processes passed "
                             f"different data (length, crc32 by rank: "
                             f"{seen})")
    masters = _masters(len(arr))

    local = []
    for j, (start, end, final) in enumerate(masters):
        if j % world != rank:
            continue
        part = BitStream()
        deflate_part(options, 2, final, arr, start, end, part)
        local.append({
            "idx": j,
            "segments": part._segments,
            "crc": containers.crc32(arr[start:end]),
            "adler": containers.adler32(arr[start:end]),
            "nbytes": end - start,
        })

    blobs = _allgather_bytes(pickle.dumps(local))
    if rank != 0:
        return None

    # Only blobs this program's ranks wrote are unpickled.
    entries = sorted((e for b in blobs for e in pickle.loads(b)),
                     key=lambda e: e["idx"])
    if [e["idx"] for e in entries] != list(range(len(masters))):
        raise RuntimeError("compress_multihost: a master part is missing")

    out = BitStream()
    crc = 0
    adler = 1
    for e in entries:
        part = BitStream()
        part._segments = e["segments"]  # extend() replays segments only
        out.extend(part)
        crc = containers.crc32_combine(crc, e["crc"], e["nbytes"])
        adler = containers.adler32_combine(adler, e["adler"], e["nbytes"])

    payload = out.getvalue()
    if fmt == "deflate":
        return payload
    if fmt == "gzip":
        return containers.gzip_frame(payload, crc, len(arr))
    return containers.zlib_frame(payload, adler)
