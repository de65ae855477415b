"""A reader and writer of the safetensors format, F32, F16 and BF16.

Diffusers snapshots store weights as safetensors; the card's machine has
no ``safetensors`` package, so the port reads and writes the format
itself. A file is an 8-byte little-endian header length N, N bytes of
JSON (``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` of strings, padded with spaces to a multiple
of 8), then the tensors' little-endian bytes back to back, offsets
relative to the end of the header.
"""

from __future__ import annotations

import json
import math
import struct
from typing import Dict, Optional

import numpy as np
import torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}
_NUMPY = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file in its stored dtype: CPU views of one
    buffer that holds the file's data."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
        data = np.fromfile(f, dtype=np.uint8)
    out = {}
    for name, e in header.items():
        if name == "__metadata__":
            continue
        if e["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has dtype {e['dtype']}; "
                             "only F32, F16 and BF16 are read")
        begin, end = e["data_offsets"]
        shape = tuple(e["shape"])
        npdt = np.dtype(_NUMPY[e["dtype"]])
        if end - begin != math.prod(shape) * npdt.itemsize \
                or end > data.size:
            raise ValueError(f"{path}: {name}'s offsets {begin}:{end} do "
                             f"not hold {e['dtype']} {list(shape)}")
        arr = data[begin:end].view(npdt).reshape(shape) \
            if begin % npdt.itemsize == 0 \
            else data[begin:end].copy().view(npdt).reshape(shape)
        t = torch.from_numpy(arr)
        if e["dtype"] == "BF16":
            t = t.view(torch.bfloat16)
        out[name] = t
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (F32, F16 or BF16, any device) to ``path``."""
    header, blobs, offset = {}, [], 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name in sorted(tensors):
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name} has dtype {t.dtype}; only float32, "
                             "float16 and bfloat16 are written")
        t = t.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        raw = t.numpy().tobytes()
        header[name] = {"dtype": _NAMES[tensors[name].dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
