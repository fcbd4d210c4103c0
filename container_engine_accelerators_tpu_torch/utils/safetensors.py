"""The safetensors file format, read and written by hand (the package
is not known to be on the card's machine): an 8-byte little-endian
header length, the JSON header {name: {dtype, shape, data_offsets}},
padded with spaces to 8 bytes, then each tensor's raw little-endian
bytes. Tensors go to and from the file as bytes, with no conversion and
no checksum, so a write or a read runs at the speed of a memory copy.
HF exports use it (models/convert.py), and so do training checkpoints
(training/checkpoint.py)."""

from __future__ import annotations

import json
import struct

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def header_of(tensors: dict[str, torch.Tensor]) -> dict:
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: no safetensors dtype for {t.dtype}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    return header


# A card tensor reaches the file through one pinned staging buffer of
# this size, a chunk at a time: the copies run at the link's rate and no
# host copy of the whole tensor is held.
STAGE_BYTES = 64 << 20


def write(f, tensors: dict[str, torch.Tensor]) -> None:
    """Write tensors to the binary file object `f`, in order."""
    blob = json.dumps(header_of(tensors)).encode()
    blob += b" " * (-len(blob) % 8)
    f.write(struct.pack("<Q", len(blob)))
    f.write(blob)
    stage = None
    for t in tensors.values():
        flat = t.detach().contiguous().view(-1).view(torch.uint8)
        if not flat.is_cuda:
            f.write(memoryview(flat.numpy()))
            continue
        if stage is None:
            stage = torch.empty(STAGE_BYTES, dtype=torch.uint8,
                                pin_memory=True)
        for i in range(0, flat.numel(), STAGE_BYTES):
            part = flat[i:i + STAGE_BYTES]
            chunk = stage[:part.numel()]
            chunk.copy_(part)       # waits for the copy: chunk is reused
            f.write(memoryview(chunk.numpy()))


def read_header(f) -> tuple[dict, int]:
    """(header without __metadata__, offset of the data) of an open
    file; raises ValueError on a header that does not parse."""
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError("truncated safetensors header")
    (n,) = struct.unpack("<Q", raw)
    try:
        header = json.loads(f.read(n))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(f"unreadable safetensors header: {e}") from e
    header.pop("__metadata__", None)
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{name} has dtype {info['dtype']}")
    return header, 8 + n


def read_tensor(f, info: dict, data_start: int) -> torch.Tensor:
    """One tensor of `info` (a header entry) read from `f` into a new CPU
    tensor."""
    begin, end = info["data_offsets"]
    t = torch.empty(info["shape"], dtype=DTYPES[info["dtype"]])
    if t.numel() * t.element_size() != end - begin:
        raise ValueError(f"header offsets {begin}-{end} do not hold "
                         f"{info['shape']} {info['dtype']}")
    f.seek(data_start + begin)
    if f.readinto(memoryview(t.view(-1).view(torch.uint8).numpy())) \
            != end - begin:
        raise ValueError("file ends inside a tensor")
    return t


def read(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one `.safetensors` file, as CPU tensors."""
    with open(path, "rb") as f:
        header, start = read_header(f)
        return {name: read_tensor(f, info, start)
                for name, info in header.items()}
