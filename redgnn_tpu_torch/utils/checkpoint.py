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
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

EXT = ".pt"


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
