"""The safetensors format, read and written without the ``safetensors``
package (counterpart of the safetensors part of
``hcpdiff_tpu/ckpt/formats.py``; the port depends on no such package).

A file is an 8-byte little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}`` padded with spaces to a multiple of 8 bytes, then the
tensors' raw little-endian bytes, offsets counted from the end of the
header. ``load_file`` reads the file once into one buffer and returns
tensors that are views of it; ``save_file`` writes tensors in the
reference writer's order (larger element size first, then by name), so
each tensor's offset is a multiple of its element size.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

DTYPES = {'F64': torch.float64, 'F32': torch.float32, 'F16': torch.float16,
          'BF16': torch.bfloat16, 'I64': torch.int64, 'I32': torch.int32,
          'I16': torch.int16, 'I8': torch.int8, 'U8': torch.uint8, 'BOOL': torch.bool}
NAMES = {v: k for k, v in DTYPES.items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a .safetensors file."""
    size = os.path.getsize(path)
    buf = bytearray(size)
    with open(path, 'rb') as f:
        if f.readinto(buf) != size:
            raise OSError(f'{path}: short read')
    if size < 8:
        raise ValueError(f'{path}: not a safetensors file ({size} bytes)')
    (n,) = struct.unpack('<Q', buf[:8])
    if 8 + n > size:
        raise ValueError(f'{path}: header length {n} past the end of the file')
    header = json.loads(bytes(buf[8:8 + n]).decode('utf-8'))
    data = torch.frombuffer(buf, dtype=torch.uint8)[8 + n:] if size > 8 + n else \
        torch.empty(0, dtype=torch.uint8)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        if info['dtype'] not in DTYPES:
            raise ValueError(f'{path}: tensor {name!r} has unsupported dtype {info["dtype"]}')
        dtype = DTYPES[info['dtype']]
        begin, end = info['data_offsets']
        shape = tuple(info['shape'])
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != itemsize * int(np.prod(shape, dtype=np.int64)) or end > data.numel():
            raise ValueError(f'{path}: tensor {name!r} offsets {begin}-{end} do not fit '
                             f'{info["dtype"]} {list(shape)}')
        raw = data[begin:end]
        if (8 + n + begin) % itemsize:
            raw = raw.clone()              # a view as `dtype` needs an aligned offset
        out[name] = raw.view(dtype).reshape(shape)
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write {name: tensor} (on any device)."""
    items = []
    for name, t in tensors.items():
        if t.dtype not in NAMES:
            raise ValueError(f'tensor {name!r}: dtype {t.dtype} has no safetensors name')
        items.append((name, t.detach().to('cpu').contiguous()))
    items.sort(key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, object] = {}
    if metadata:
        header['__metadata__'] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {'dtype': NAMES[t.dtype], 'shape': list(t.shape),
                        'data_offsets': [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header, separators=(',', ':')).encode('utf-8')
    head += b' ' * (-len(head) % 8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(head)))
        f.write(head)
        for _, t in items:
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
