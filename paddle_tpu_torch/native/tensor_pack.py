"""Binary packing of tensor batches for the native byte queues and recordio
records (counterpart of ``paddle_tpu/native/tensor_pack.py``).

The wire form is the JAX package's byte for byte, so a record written by
either package reads in the other.  Upstream serializes a LoDTensor as
version + proto + raw bytes (framework/lod_tensor.cc SerializeToStream);
this is the packed form the reader queues and recordio datasets carry.

batch := u32 n_tensors | tensor*
tensor := u8 dtype_len | dtype_str | u8 ndim | i64 dims[ndim]
        | u8 lod_levels | { u32 count | i64 offsets[count] }*
        | raw bytes (C-order)
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np


def pack_batch(items: Sequence[Tuple[np.ndarray, Optional[tuple]]]) -> bytes:
    out = [struct.pack("<I", len(items))]
    for arr, lod in items:
        arr = np.ascontiguousarray(arr)
        dt = arr.dtype.str.encode()
        out.append(struct.pack("<B", len(dt)))
        out.append(dt)
        out.append(struct.pack("<B", arr.ndim))
        out.append(struct.pack(f"<{arr.ndim}q", *arr.shape))
        lod = lod or ()
        out.append(struct.pack("<B", len(lod)))
        for level in lod:
            out.append(struct.pack("<I", len(level)))
            out.append(struct.pack(f"<{len(level)}q", *level))
        out.append(arr.tobytes())
    return b"".join(out)


def unpack_batch(data: bytes) -> List[Tuple[np.ndarray, tuple]]:
    pos = 0
    (n,) = struct.unpack_from("<I", data, pos)
    pos += 4
    items = []
    for _ in range(n):
        (dt_len,) = struct.unpack_from("<B", data, pos)
        pos += 1
        dt = np.dtype(data[pos: pos + dt_len].decode())
        pos += dt_len
        (ndim,) = struct.unpack_from("<B", data, pos)
        pos += 1
        dims = struct.unpack_from(f"<{ndim}q", data, pos)
        pos += 8 * ndim
        (levels,) = struct.unpack_from("<B", data, pos)
        pos += 1
        lod = []
        for _ in range(levels):
            (cnt,) = struct.unpack_from("<I", data, pos)
            pos += 4
            lod.append(tuple(struct.unpack_from(f"<{cnt}q", data, pos)))
            pos += 8 * cnt
        nbytes = int(np.prod(dims)) * dt.itemsize if ndim else dt.itemsize
        arr = np.frombuffer(data, dtype=dt, count=int(np.prod(dims)) if ndim
                            else 1, offset=pos).reshape(dims)
        pos += nbytes
        items.append((arr, tuple(lod)))
    return items
