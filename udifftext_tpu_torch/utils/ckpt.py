"""Reading reference checkpoints into the port's modules (port of the
loading half of `udifftext_tpu/utils/ckpt_torch.py`).

The port's modules carry the reference state-dict keys, so a checkpoint
needs no converter: `load_state_dict` reads a `.ckpt`/`.pt`/`.pth` (torch
pickle, a Lightning checkpoint's "state_dict" unwrapped) or a
`.safetensors` file into a flat dict of CPU tensors, `strip_prefix` selects
one component's keys, and `merge_state_dict` loads them into a module the
way the reference's strict=False boot does (diffusion.py:87-105): keys the
file lacks keep their initial values, keys the module lacks are ignored,
and a key whose shape differs keeps its initial value too. All three are
reported, as state-dict keys.

`.safetensors` is read here, without the `safetensors` package: an 8-byte
little-endian header length, a JSON header of {name: {dtype, shape,
data_offsets}}, then the raw little-endian bytes, mapped from the file.
"""

from __future__ import annotations

import json
import mmap
import os
import pickle
import zipfile
from typing import Dict, List, Tuple

import torch
from torch import nn

# safetensors dtype names → torch dtypes (the ones reference checkpoints use)
SAFETENSORS_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file as {name: CPU tensor}; the tensors are views of
    a private (copy-on-write) map of the file, so nothing is read twice."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        n = int.from_bytes(head, "little")
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes past the end of a {size}-byte file")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else b""
    start, data_len = 8 + n, size - 8 - n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']!r}; this reader "
                             f"takes {sorted(SAFETENSORS_DTYPES)}")
        shape = [int(d) for d in info["shape"]]
        lo, hi = (int(o) for o in info["data_offsets"])
        count = 1
        for d in shape:
            count *= d
        nbytes = count * torch.empty((), dtype=dtype).element_size()
        if not 0 <= lo <= hi <= data_len or hi - lo != nbytes:
            raise ValueError(f"{path}: tensor {name!r} {info['dtype']}{shape} at bytes "
                             f"[{lo}, {hi}) of a {data_len}-byte data section")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=start + lo).reshape(shape)
    return out


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file as a flat {key: CPU tensor} dict. `.safetensors`
    goes through `load_safetensors`; anything else through `torch.load`
    (memory-mapped when the file is in torch's zip format), with a
    Lightning checkpoint's "state_dict" unwrapped and non-tensor entries
    dropped. A pickle that holds more than tensors and plain containers
    (a Lightning checkpoint's hyper-parameters, say) is loaded with
    `weights_only=False`, as the JAX package loads every checkpoint: that
    runs the file's pickled code, so load only checkpoints you trust."""
    path = str(path)
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    kw = {"map_location": "cpu", "mmap": zipfile.is_zipfile(path)}
    try:
        obj = torch.load(path, weights_only=True, **kw)
    except pickle.UnpicklingError:
        print(f"[ckpt] {path} holds objects other than tensors: loading it with "
              "weights_only=False")
        obj = torch.load(path, weights_only=False, **kw)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def strip_prefix(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of `sd` under `prefix`, with the prefix removed."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def merge_state_dict(module: nn.Module, sd: Dict[str, torch.Tensor], label: str,
                     verbose: bool = True) -> Tuple[List[str], List[str], List[str]]:
    """strict=False load of `sd` into `module`, in place: every matching key
    is copied into its parameter or buffer (cast to its dtype, on its
    device, in its memory format); a key of the module that `sd` lacks
    keeps its value (missing), a key of `sd` the module lacks is ignored
    (unexpected), and a key whose shape differs keeps the module's value
    (mismatched, "key: ckpt(shape) vs init(shape)"). Returns (missing,
    unexpected, mismatched) and, with `verbose`, prints them as the JAX
    package's `load_from_torch_ckpt` does."""
    own = module.state_dict()
    mismatched = [f"{k}: ckpt{tuple(v.shape)} vs init{tuple(own[k].shape)}"
                  for k, v in sd.items() if k in own and v.shape != own[k].shape]
    keep = {k: v for k, v in sd.items() if k in own and v.shape == own[k].shape}
    module.load_state_dict(keep, strict=False)
    missing = [k for k in own if k not in sd]
    unexpected = [k for k in sd if k not in own]
    if verbose:
        print(f"[{label}] merged with {len(missing)} missing, {len(unexpected)} unexpected, "
              f"{len(mismatched)} mismatched keys")
        for m in mismatched[:10]:
            print(f"  mismatch: {m}")
    return missing, unexpected, mismatched
