"""Fault-tolerant checkpointing: atomic, content-addressed, sealable (port
of ``repro.train.checkpoint``).

  * **atomic**: written to a temp dir, the manifest fsynced, then renamed:
    a crash mid-save never corrupts the latest good checkpoint;
  * **verifiable**: every plain leaf carries a SHA-256, and a restore
    refuses a corrupted file;
  * **confidential**: with a TrustDomain, leaves are sealed (ChaCha20 +
    HMAC, on the leaf's device), so checkpoints at rest never expose
    weights.

The files and the manifest are the reference's, so a checkpoint written by
either package restores in the other: ``step_{n}/leaf_{i:05d}.npy`` in the
tree's flattening order (``.params[...]``, ``.opt.m[...]``, ``.opt.v[...]``,
``.opt.step`` for a train state), sealed under ``ckpt/{step}{name}`` as
uint32 ``[16, N]`` ciphertext. A bf16 leaf is stored as the reference
stores it: raw 2-byte records under a ``<V2`` header with dtype
``"bfloat16"`` in the manifest (the port reads and writes the bits without
``ml_dtypes``). Leaves are stored whole, so a restore onto another layout
needs no conversion; placing them onto another mesh's shards is ROADMAP.md
queue A item 21 part 2.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.confidential import TrustDomain
from repro_torch.core.sealing import (SealedTensor, seal_tensor,
                                      tree_leaves_with_names,
                                      tree_map_with_names, unseal_tensor)
from repro_torch.device import resolve_device

Params = Any

_BF16_DESCR = "<V2"    # the header numpy writes for ml_dtypes' bfloat16


def _host_array(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(numpy array of the leaf's bytes, numpy dtype name); a bf16 leaf is
    its uint16 bits, named "bfloat16"."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _save_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _from_host(raw: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(raw.copy().view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(raw.copy())


def save_checkpoint(directory: str | Path, step: int, tree: Params, *,
                    trust_domain: Optional[TrustDomain] = None) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f".tmp_step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest: Dict[str, Any] = {"step": step, "leaves": {}, "sealed": False}
    for i, (name, leaf) in enumerate(tree_leaves_with_names(tree)):
        fname = f"leaf_{i:05d}.npy"
        if trust_domain is not None and trust_domain.confidential:
            st = seal_tensor(trust_domain.sealing_key, f"ckpt/{step}{name}",
                             leaf)
            np.save(tmp / fname, st.ciphertext.cpu().numpy().view(np.uint32))
            manifest["sealed"] = True
            entry = {"name": name, "file": fname, "shape": list(st.shape),
                     "dtype": st.dtype, "n_bytes": st.n_bytes,
                     "mac": st.mac.hex()}
        else:
            arr, dtype = _host_array(leaf)
            _save_npy(tmp / fname, arr, dtype)
            entry = {"name": name, "file": fname, "shape": list(arr.shape),
                     "dtype": dtype,
                     "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
        manifest["leaves"][str(i)] = entry
    mpath = tmp / "manifest.json"
    mpath.write_text(json.dumps(manifest))
    with open(mpath) as f:
        os.fsync(f.fileno())
    final = directory / f"step_{step}"
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    (directory / "LATEST.tmp").write_text(str(step))
    (directory / "LATEST.tmp").rename(directory / "LATEST")
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    p = Path(directory) / "LATEST"
    if not p.exists():
        return None
    step = int(p.read_text())
    return step if (Path(directory) / f"step_{step}").exists() else None


class CorruptCheckpoint(Exception):
    pass


def restore_checkpoint(directory: str | Path, step: int, treedef_like: Params,
                       *, trust_domain: Optional[TrustDomain] = None,
                       device=None) -> Params:
    """Restore into the dict and NamedTuple structure of ``treedef_like``
    (its leaves' values are not read). Each leaf lands on ``device``, or
    else on its like's device; a meta-device like (an abstract state) puts
    it on the card, as ``resolve_device`` decides. A sealed leaf is
    verified and decrypted there."""
    d = Path(directory) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    like = list(tree_leaves_with_names(treedef_like))
    if len(like) != len(manifest["leaves"]):
        raise CorruptCheckpoint(
            f"leaf count mismatch: {len(like)} vs {len(manifest['leaves'])}")
    leaves = {}
    for i, (name, like_leaf) in enumerate(like):
        entry = manifest["leaves"][str(i)]
        raw = np.load(d / entry["file"])
        dev = device if device is not None else like_leaf.device
        dev = resolve_device(None if torch.device(dev).type == "meta"
                             else dev)
        if manifest["sealed"]:
            if trust_domain is None:
                raise CorruptCheckpoint("sealed checkpoint requires a TrustDomain")
            st = SealedTensor(
                name=f"ckpt/{step}{entry['name']}",
                ciphertext=torch.from_numpy(raw.view(np.int32)).to(dev),
                mac=bytes.fromhex(entry["mac"]),
                shape=tuple(entry["shape"]), dtype=entry["dtype"],
                n_bytes=entry["n_bytes"])
            leaves[name] = unseal_tensor(trust_domain.sealing_key, st)
        else:
            digest = hashlib.sha256(raw.tobytes()).hexdigest()
            if digest != entry["sha256"]:
                raise CorruptCheckpoint(f"digest mismatch for {entry['name']}")
            leaves[name] = _from_host(raw, entry["dtype"]).to(dev)
    return tree_map_with_names(lambda name, _: leaves[name], treedef_like)


@dataclasses.dataclass
class CheckpointManager:
    """Restart-on-failure orchestration: keep_n retention + auto-resume."""
    directory: Path
    keep_n: int = 3
    trust_domain: Optional[TrustDomain] = None

    def __post_init__(self):
        self.directory = Path(self.directory)

    def save(self, step: int, tree: Params) -> Path:
        path = save_checkpoint(self.directory, step, tree,
                               trust_domain=self.trust_domain)
        self._gc()
        return path

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.directory.glob("step_*"))
        for s in steps[:-self.keep_n]:
            shutil.rmtree(self.directory / f"step_{s}", ignore_errors=True)

    def resume(self, treedef_like: Params, device=None
               ) -> Tuple[Optional[int], Optional[Params]]:
        step = latest_step(self.directory)
        if step is None:
            return None, None
        tree = restore_checkpoint(self.directory, step, treedef_like,
                                  trust_domain=self.trust_domain,
                                  device=device)
        return step, tree
