"""Checkpoint / resume.

Port of ``redgnn_tpu/utils/checkpoint.py`` with the same functions and
file-naming scheme: `{metric:.5f}.{epoch}.pt` files saved on valid-metric
improvement and pruned to the best few, `latest.pt` overwritten every
epoch as the restart anchor, and an optional JSON sidecar
(`<file>.host.json`) for host-side training state (the numpy rng that
draws the per-epoch re-split), so a resumed run continues with the same
splits. The sidecar is optional on load.

The device state (a nested dict of tensors) is serialised with
``torch.save`` and read back with ``torch.load(weights_only=True)`` onto
the CPU; the caller copies it to its device.

The JAX package's own checkpoints (flax msgpack, `{metric}.{epoch}.msgpack`)
are read by `load_msgpack`, whose decoder is written here in Python: the
card's machine has no ``msgpack`` package.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from redgnn_tpu_torch.utils.port_params import (
    params_from_flax,
    temporal_opt_state_from_optax,
)

EXT = ".pt"


def new_checkpoint_dir(root: str, prefix: str = "checkpoints") -> str:
    """Timestamped checkpoint directory (`utils.py:679-690`)."""
    stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
    path = os.path.join(root, f"{prefix}_{stamp}")
    os.makedirs(path, exist_ok=True)
    return path


def _write_host(path: str, host: Optional[Dict[str, Any]]) -> None:
    if host is None:
        # don't leave a stale sidecar paired with a host-less save
        try:
            os.remove(path + ".host.json")
        except OSError:
            pass
        return
    tmp = path + ".host.tmp"
    with open(tmp, "w") as f:
        json.dump(host, f)
    os.replace(tmp, path + ".host.json")


def load_host(path: str) -> Optional[Dict[str, Any]]:
    """Host-state sidecar of checkpoint ``path``: None if there is none,
    ValueError if there is one that does not parse."""
    try:
        with open(path + ".host.json") as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except ValueError as err:
        raise ValueError(f"{path}.host.json is not valid JSON: {err}") from err


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _with_meta(state: Dict[str, Any], epoch: int, metric: float):
    return dict(_to_cpu(state),
                _meta=torch.tensor([epoch, metric], dtype=torch.float64))


def _metric_of(path: str) -> float:
    return float(os.path.basename(path)[:-len(EXT)].rsplit(".", 1)[0])


def _ranked(ckpt_dir: str):
    return [p for p in glob.glob(os.path.join(ckpt_dir, "*" + EXT))
            if os.path.basename(p) != "latest" + EXT]


def save_checkpoint(ckpt_dir: str, state: Dict[str, Any], epoch: int,
                    metric: float, keep: int = 3,
                    host: Optional[Dict[str, Any]] = None) -> str:
    """Write `{metric:.5f}.{epoch}.pt`; prune to the best ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{metric:.5f}.{epoch}{EXT}")
    torch.save(_with_meta(state, epoch, metric), path)
    _write_host(path, host)
    for stale in sorted(_ranked(ckpt_dir), key=_metric_of,
                        reverse=True)[keep:]:
        os.remove(stale)
        if os.path.exists(stale + ".host.json"):
            os.remove(stale + ".host.json")
    return path


def _check_like(got, template, where: str) -> None:
    if isinstance(template, dict):
        if not isinstance(got, dict) or got.keys() != template.keys():
            raise ValueError(f"checkpoint structure differs at {where}")
        for k in template:
            _check_like(got[k], template[k], f"{where}/{k}")
    elif tuple(got.shape) != tuple(template.shape) \
            or got.dtype != template.dtype:
        raise ValueError(
            f"checkpoint leaf {where}: {tuple(got.shape)} {got.dtype}, "
            f"expected {tuple(template.shape)} {template.dtype}")


def load_checkpoint(path: str, template: Dict[str, Any]
                    ) -> Tuple[Dict[str, Any], int, float]:
    """Restore a state tree (CPU tensors) from a checkpoint file.

    ``template`` must have the same structure, shapes and dtypes (an
    initialized trainer's state); anything else raises ``ValueError``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    meta = state.pop("_meta")
    _check_like(state, template, "")
    return state, int(meta[0]), float(meta[1])


def save_latest(ckpt_dir: str, state: Dict[str, Any], epoch: int,
                metric: float,
                host: Optional[Dict[str, Any]] = None) -> str:
    """Overwrite `latest.pt` — the restart anchor: written every epoch so
    that a crashed run resumes from the last completed epoch."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, ".latest.tmp")
    torch.save(_with_meta(state, epoch, metric), tmp)
    path = os.path.join(ckpt_dir, "latest" + EXT)
    # sidecar first, then the rename: a crash in between pairs the old
    # checkpoint with the new sidecar for one restart, never a new
    # checkpoint with a stale rng sidecar
    _write_host(path, host)
    os.replace(tmp, path)
    return path


def load_latest(ckpt_dir: str, template: Dict[str, Any]
                ) -> Optional[Tuple[Dict[str, Any], int, float]]:
    path = os.path.join(ckpt_dir, "latest" + EXT)
    if not os.path.exists(path):
        return None
    return load_checkpoint(path, template)


def best_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = _ranked(ckpt_dir)
    if not ckpts:
        return None
    return max(ckpts, key=_metric_of)


# ------------------------------------------------ flax msgpack checkpoints

class _Reader:
    """A msgpack decoder (the subset flax writes: maps, arrays, str, bin,
    nil, bool, int, float, ext) over one bytes object. Ext type 1 is a
    flax ndarray: the msgpack of (shape, dtype name, C-order bytes); ext 3
    a numpy scalar in the same form; ext 2 a complex (real, imag)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def value(self, text: bool = True):
        c = self.uint(1)
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F, text)
        if 0x90 <= c <= 0x9F:
            return [self.value(text) for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.str(c & 0x1F, text)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        if c in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return self.take(self.uint(1 << (c - 0xC4)))
        if c in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.uint(1 << (c - 0xC7))
            return self.ext(self.sint(1), self.take(n))
        if c == 0xCA:
            return float(np.frombuffer(self.take(4), ">f4")[0])
        if c == 0xCB:
            return float(np.frombuffer(self.take(8), ">f8")[0])
        if 0xCC <= c <= 0xCF:
            return self.uint(1 << (c - 0xCC))
        if 0xD0 <= c <= 0xD3:
            return self.sint(1 << (c - 0xD0))
        if 0xD4 <= c <= 0xD8:  # fixext 1/2/4/8/16
            code = self.sint(1)
            return self.ext(code, self.take(1 << (c - 0xD4)))
        if c in (0xD9, 0xDA, 0xDB):
            return self.str(self.uint(1 << (c - 0xD9)), text)
        if c in (0xDC, 0xDD):
            return [self.value(text) for _ in range(self.uint(2 << (c - 0xDC)))]
        if c in (0xDE, 0xDF):
            return self.map(self.uint(2 << (c - 0xDE)), text)
        raise ValueError(f"msgpack type byte {c:#x} is not supported")

    def str(self, n: int, text: bool):
        raw = self.take(n)
        return raw.decode("utf-8") if text else raw

    def map(self, n: int, text: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.value(text)
            out[k] = self.value(text)
        return out

    @staticmethod
    def ext(code: int, payload: bytes):
        if code in (1, 3):  # flax ndarray / numpy scalar
            shape, dtype, buf = _Reader(payload).value(text=False)
            arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode()),
                                count=-1).reshape(shape, order="C")
            return arr if code == 1 else arr[()]
        if code == 2:  # complex
            re, im = _Reader(payload).value()
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not supported")


def _unchunk(tree):
    """flax splits arrays above 1 GiB into ``__msgpack_chunked_array__``
    dicts; join them back."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """``flax.serialization.msgpack_restore`` without msgpack or flax: the
    nested dict of numpy arrays and Python values of a flax ``.msgpack``
    checkpoint (arrays are read-only views of ``data``)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(out)


def load_msgpack(path: str) -> Tuple[Dict[str, Any], int, float]:
    """The JAX package's checkpoint file ``path`` (`{metric}.{epoch}.msgpack`
    or `latest.msgpack`): (state tree of numpy arrays, epoch, metric)."""
    with open(path, "rb") as f:
        state = msgpack_restore(f.read())
    meta = state.pop("_meta")
    return state, int(meta[0]), float(meta[1])


def load_trainer_checkpoint(path: str, template: Dict[str, Any],
                            lr: Optional[float] = None
                            ) -> Tuple[Dict[str, Any], int]:
    """(state, epoch) of a flat-parameter trainer's checkpoint: the port's
    ``.pt`` or the JAX package's ``.msgpack`` (parameters through
    ``params_from_flax``, the optax state through
    ``temporal_opt_state_from_optax``, which takes ``lr`` where the chain
    keeps no learning rate). A state of another structure than
    ``template`` (model shape, optimizer chain) raises RuntimeError."""
    try:
        if path.endswith(".msgpack"):
            raw, epoch, _ = load_msgpack(path)
            state = {"params": params_from_flax(raw["params"]),
                     "opt_state": temporal_opt_state_from_optax(
                         raw["opt_state"], lr)}
            _check_like(state, template, "")
        else:
            state, epoch, _ = load_checkpoint(path, template)
    except (KeyError, ValueError) as e:
        raise RuntimeError(
            f"checkpoint {path} does not match this trainer's state "
            f"structure ({e})") from e
    return state, epoch
