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
``ml_dtypes``).

  * **elastic**: leaves are stored whole. A state placed on a mesh
    (:func:`repro_torch.distributed.sharding.place`) is gathered leaf by
    leaf and written by global rank 0 alone, the files (and under a
    confidential TrustDomain the ciphertext and MACs) those of a
    one-device save of the gathered state; ``restore_checkpoint(...,
    shardings=)`` places every leaf onto another mesh's shards as it
    loads (save on mesh A, resume on mesh B).
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
from repro_torch.distributed import sharding

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


def writes(tree: Params) -> bool:
    """Does this process write a save of ``tree``? Global rank 0 alone
    writes a state placed over ranks; one process writes anything else."""
    mesh = sharding.mesh_of(tree)
    return (mesh is None or not mesh.spans_ranks
            or mesh.rank_of(*mesh.coords) == 0)


def save_checkpoint(directory: str | Path, step: int, tree: Params, *,
                    trust_domain: Optional[TrustDomain] = None) -> Path:
    """Write ``tree`` as ``step_{step}`` and publish it as the latest. A
    placed leaf is gathered whole first (over ranks every rank of its mesh
    calls this, and all of them return once rank 0 has published)."""
    directory = Path(directory)
    mesh = sharding.mesh_of(tree)
    writer = writes(tree)
    tmp = directory / f".tmp_step_{step}"
    if writer:
        directory.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
    manifest: Dict[str, Any] = {"step": step, "leaves": {}, "sealed": False}
    for i, (name, leaf) in enumerate(tree_leaves_with_names(tree)):
        if isinstance(leaf, sharding.Placed):
            leaf = sharding.gather_leaf(leaf)
        if not writer:
            continue
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
    final = directory / f"step_{step}"
    if writer:
        mpath = tmp / "manifest.json"
        mpath.write_text(json.dumps(manifest))
        with open(mpath) as f:
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        (directory / "LATEST.tmp").write_text(str(step))
        (directory / "LATEST.tmp").rename(directory / "LATEST")
    if mesh is not None and mesh.spans_ranks:
        mesh.world.barrier()
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
                       device=None, shardings: Optional[Params] = None
                       ) -> Params:
    """Restore into the dict and NamedTuple structure of ``treedef_like``
    (its leaves' values are not read). ``shardings`` (a tree of
    ``NamedSharding``, :func:`~repro_torch.distributed.sharding.to_named`,
    matching the leaves) places each leaf onto those shards as it loads:
    an elastic restore onto another mesh; a placed ``treedef_like`` gives
    its own placement by default. Else each leaf lands on ``device``, or
    on its like's device; a meta-device like (an abstract state) puts it on
    the card, as ``resolve_device`` decides. A sealed leaf is verified and
    decrypted on the device it lands on (over ranks, on every rank)."""
    d = Path(directory) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    like = list(tree_leaves_with_names(treedef_like))
    if len(like) != len(manifest["leaves"]):
        raise CorruptCheckpoint(
            f"leaf count mismatch: {len(like)} vs {len(manifest['leaves'])}")
    if shardings is None:
        shardings = sharding.placement(treedef_like)
    named = (dict(tree_leaves_with_names(shardings))
             if shardings is not None else {})
    leaves = {}
    for i, (name, like_leaf) in enumerate(like):
        entry = manifest["leaves"][str(i)]
        raw = np.load(d / entry["file"])
        target = named.get(name)
        dev = (target.mesh.device if target is not None
               else device if device is not None else like_leaf.device)
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
            leaf = unseal_tensor(trust_domain.sealing_key, st)
        else:
            digest = hashlib.sha256(raw.tobytes()).hexdigest()
            if digest != entry["sha256"]:
                raise CorruptCheckpoint(f"digest mismatch for {entry['name']}")
            leaf = _from_host(raw, entry["dtype"]).to(dev)
        leaves[name] = (sharding.place_leaf(leaf, target)
                        if target is not None else leaf)
        del leaf
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
        if writes(tree):
            self._gc()
        return path

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.directory.glob("step_*"))
        for s in steps[:-self.keep_n]:
            shutil.rmtree(self.directory / f"step_{s}", ignore_errors=True)

    def resume(self, treedef_like: Params, device=None,
               shardings: Optional[Params] = None
               ) -> Tuple[Optional[int], Optional[Params]]:
        """(step, tree) of the latest checkpoint, or (None, None); a placed
        ``treedef_like`` (or ``shardings``) resumes onto its shards."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        tree = restore_checkpoint(self.directory, step, treedef_like,
                                  trust_domain=self.trust_domain,
                                  device=device, shardings=shardings)
        return step, tree
