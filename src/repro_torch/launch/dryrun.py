"""Dry run of every (arch x shape x mesh) cell on the production mesh (port
of ``repro.launch.dryrun``), with no card and no memory.

The reference compiles each cell with XLA on 512 forced host devices and
reads FLOPs and bytes from ``cost_analysis``, collective bytes from the
HLO and the footprint from ``memory_analysis``. torch has no compiled
object: the port lowers a cell by RUNNING one rank's step program under
``FakeTensorMode``. That program is the code that runs over
``torch.distributed`` ranks on the card -- the sharded train step
(``train.make_sharded_train_step``), or the sharded prefill and decode step
(``TensorParallel`` for the decoder families, ``EncDecParallel`` for
whisper) on the weights ``param_specs`` places and the dense cache
``cache_specs`` places -- on a dry mesh (``launch.mesh.make_dry_mesh``),
whose groups are ``DryGroup``\\ s: one rank's view of ``n`` ranks, the
other ranks' tensors made from the shapes. No tensor of the model is
allocated and no kernel wrapper is reached (the dense cache's attention is plain torch,
and a prompt's attention on fake tensors takes the plain path).

Per cell (:class:`Lowered`, per device), all counted op by op by one
dispatch mode (:class:`Counter`):
  * ``flops``: ``FlopCounterMode``'s count (its registry and its rule for
    ops it decomposes);
  * ``bytes``: every aten op's input and output bytes, views excluded:
    the eager program's own, UNFUSED, device-memory traffic, where XLA's
    "bytes accessed" is the fused program's;
  * ``collectives``: the dry groups' bytes into one shard, per kind
    (all-gather, all-reduce, collective-permute, broadcast): the port's
    accounting of what moves into a shard, without the reference's ring
    factors;
  * ``arg_bytes``: the rank's shard of the state or params, the batch and
    the cache, less what the step updates in place (the cache: the
    reference donates it); ``temp_bytes``: the peak of the step's live
    allocations (each storage an op makes, alive until freed) less the
    new outputs; ``out_bytes``: the outputs (the new state, or the logits
    and the cache).

Eager execution counts every layer, so the costs need no extrapolation;
they are still taken from unit-depth variants and extrapolated affinely in
the per-block-type layer counts, as the reference does: a fake program
costs host time a layer (rwkv6's time loop runs an op sequence a token),
and the stacks are homogeneous per block type, so the totals are exact
(the tests hold them to the full-depth count). The footprint is
extrapolated from variants of 2 and 3 layers a block type
(:data:`FOOTPRINT_BASE`); the reference reads it from the full-depth
compile. The fake tensors carry the device the caller names (``cuda`` by
default, ``cpu`` in tests); the dry run never switches it. Indexing a
fake CUDA tensor takes a CUDA device guard, so naming ``cuda`` needs a
torch built with CUDA and a card visible (nothing is allocated on it); a
CPU-only torch lowers with ``--device cpu``, to the same counts.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, shape_applicable
from repro_torch.core.sealing import tree_leaves_with_names, tree_map
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.roofline.analysis import (analyze,
                                           model_flops_for)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import (abstract_train_state,
                                          make_sharded_train_step)

ASSIGNED = [
    "whisper-small", "deepseek-7b", "qwen3-32b", "deepseek-67b",
    "mistral-nemo-12b", "dbrx-132b", "deepseek-v3-671b", "jamba-v0.1-52b",
    "rwkv6-3b", "chameleon-34b",
]

# the dry groups' kinds, named as the reference's HLO names them
COLLECTIVE_KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
                    "ppermute": "collective-permute",
                    "broadcast": "broadcast"}


# ---------------------------------------------------------------------------
# block-count parameterization (for affine cost extrapolation)
# ---------------------------------------------------------------------------

def block_counts(cfg: ModelConfig) -> Dict[str, int]:
    if cfg.family == "encdec":
        return {"enc": cfg.encoder_layers, "dec": cfg.decoder_layers}
    if cfg.family == "hybrid":
        return {"groups": cfg.num_layers // cfg.attn_period}
    if cfg.moe is not None and cfg.moe.first_k_dense:
        return {"dense": cfg.moe.first_k_dense,
                "moe": cfg.num_layers - cfg.moe.first_k_dense}
    return {"layers": cfg.num_layers}


def with_counts(cfg: ModelConfig, counts: Dict[str, int],
                scan: bool) -> ModelConfig:
    """``cfg`` at the given per-block-type layer counts. ``scan`` is the
    reference's ``scan_layers``, kept in the config; eager torch runs a
    Python loop either way."""
    par = dataclasses.replace(cfg.parallel, scan_layers=scan)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, encoder_layers=counts["enc"],
                                   decoder_layers=counts["dec"],
                                   num_layers=max(counts.values()), parallel=par)
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg, num_layers=counts["groups"] * cfg.attn_period, parallel=par)
    if cfg.moe is not None and cfg.moe.first_k_dense:
        return dataclasses.replace(
            cfg, num_layers=counts["dense"] + counts["moe"],
            moe=dataclasses.replace(cfg.moe, first_k_dense=counts["dense"]),
            parallel=par)
    return dataclasses.replace(cfg, num_layers=counts["layers"], parallel=par)


# ---------------------------------------------------------------------------
# what a lowering counts
# ---------------------------------------------------------------------------

def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


# allocations that read nothing and write nothing yet
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh"}


class Counter(TorchDispatchMode):
    """One pass's FLOPs, device-memory traffic and live allocations, op by
    op. FLOPs follow ``FlopCounterMode`` exactly: its registry, its
    metadata queries left alone, and an op outside the registry counted
    through its decomposition when it has one. Traffic is each op's input
    and output bytes (a view moves nothing, nor does an allocation, nor a
    query that returns no tensor). Memory: each storage an op's output
    holds counts from the op until it is freed, unless the storage was
    there before the pass (an output that shares an untracked input's
    storage: a view of an argument, or an argument written in place);
    ``peak`` is the most live at once."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = self.bytes = self.live = self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}

    def _track(self, t: torch.Tensor, inputs) -> None:
        st = t.untyped_storage()
        key = id(st)
        ref = self._refs.get(key)
        if (ref is not None and ref() is st) or key in inputs:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            self.live -= n
            self._refs.pop(key, None)

        self._refs[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        packet = func.overloadpacket
        if packet not in self.registry and func is not _DEVICE:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs, out_val=out)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        if outs and not (func.is_view or packet.__name__ in _NO_TRAFFIC):
            self.bytes += sum(map(_nbytes, outs)) + sum(map(_nbytes, ins))
        inputs = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            self._track(t, inputs)
        return out


_A = torch.ops.aten
# the queries FlopCounterMode passes through uncounted
_METADATA = {_A.sym_is_contiguous.default, _A.is_contiguous.default,
             _A.is_contiguous.memory_format,
             _A.is_strides_like_format.default,
             _A.is_non_overlapping_and_dense.default, _A.size.default,
             _A.sym_size.default, _A.stride.default, _A.sym_stride.default,
             _A.storage_offset.default, _A.sym_storage_offset.default,
             _A.numel.default, _A.sym_numel.default, _A.dim.default,
             torch.ops.prim.layout.default}
_DEVICE = torch.ops.prim.device.default


@dataclasses.dataclass
class Lowered:
    """One rank's step, lowered under fake tensors: per-device FLOPs,
    device-memory bytes (unfused), collective bytes into one shard by kind,
    and the footprint's argument, temporary and output bytes; ``seconds``
    is the host time the lowering took."""
    flops: float
    bytes: float
    collectives: Dict[str, float]
    arg_bytes: int
    temp_bytes: int
    out_bytes: int
    seconds: float = 0.0

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collectives.values()))


def _tree_bytes(tree) -> int:
    """Bytes of a tree's tensors and placed leaves' local blocks, each
    storage once."""
    seen, total = set(), 0
    for _, leaf in tree_leaves_with_names(tree):
        tensors = (list(leaf.blocks.values())
                   if isinstance(leaf, sharding.Placed) else [leaf])
        for t in tensors:
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                total += _nbytes(t)
    return total


def _dry_groups(mesh):
    return list({id(g): g for g in list(mesh.groups.values())
                 + [mesh.flat]}.values())


def _lower(mesh, fn, arg_bytes: int, donated_bytes: int) -> Lowered:
    """Run ``fn()`` (-> the tree of its new outputs) once under the
    :class:`Counter` and read the dry groups' bytes by kind.
    ``donated_bytes``: the inputs the step updates in place, outputs
    too."""
    groups = _dry_groups(mesh)
    for g in groups:
        g.take()
        g.kinds.clear()
    counter = Counter()
    t0 = time.perf_counter()
    with counter:
        new = fn()
    seconds = time.perf_counter() - t0
    new_bytes = _tree_bytes(new)
    coll: Dict[str, float] = {}
    for g in groups:
        for kind, b in g.kinds.items():
            name = COLLECTIVE_KINDS.get(kind, kind)
            coll[name] = coll.get(name, 0.0) + float(b)
        g.take()
        g.kinds.clear()
    return Lowered(flops=float(counter.flops), bytes=float(counter.bytes),
                   collectives=coll, arg_bytes=int(arg_bytes),
                   temp_bytes=int(max(counter.peak - new_bytes, 0)),
                   out_bytes=int(new_bytes + donated_bytes),
                   seconds=seconds)


# ---------------------------------------------------------------------------
# lowering one step program for a given config variant
# ---------------------------------------------------------------------------

def serving_cache_specs(cfg, cache, mesh):
    """``cache_specs`` as the port holds the cache on a rank: MLA's latent
    whole over ``model`` (every model shard computes the same rows; see
    ``distributed/tensor_parallel.py``)."""
    def spec(names, sp):
        if names[-1] in ("ckv", "krope"):
            return tuple(None if a == "model" else a for a in sp)
        return sp

    return sharding._map_with_names(spec, sharding.cache_specs(cfg, cache,
                                                               mesh))


def _zeros(meta, device):
    return torch.zeros(meta.shape, dtype=meta.dtype, device=device)


def lower_step(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Lowered:
    """One rank's train step, prefill or decode step of ``cfg`` at
    ``shape`` on ``mesh`` (a dry mesh), run under ``FakeTensorMode`` with
    the counters on; the fake tensors carry the mesh's device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.tensor_parallel import (EncDecParallel,
                                                         TensorParallel,
                                                         gathered_shards)

    dev = mesh.device
    model = build_model(cfg, device="meta")
    named = lambda tree: sharding.to_named(mesh, tree)
    with FakeTensorMode():
        if shape.step_kind == "train":
            opt = AdamWConfig(moment_dtype=cfg.parallel.optimizer_dtype)
            astate = abstract_train_state(model, opt)
            sspecs = sharding.state_specs(cfg, astate, mesh)
            meta = model.train_batch_specs(shape)
            bspecs = sharding.batch_specs(cfg, meta, mesh)
            state = sharding.place_abstract(astate, named(sspecs))
            batch = {k: _zeros(v, dev) for k, v in meta.items()}
            step = make_sharded_train_step(
                model, opt, mesh, sspecs, bspecs,
                microbatches=cfg.parallel.microbatches)
            args = _tree_bytes(state) + _tree_bytes(
                sharding.place_abstract(meta, named(bspecs)))
            return _lower(mesh, lambda: dict(zip(("state", "metrics"),
                                                 step(state, batch))),
                          args, 0)
        aparams = model.abstract_params()
        pspecs = sharding.param_specs(cfg, aparams, mesh)
        params = sharding.place_abstract(aparams, named(pspecs))
        acache = model.cache_specs(shape)
        cspecs = serving_cache_specs(cfg, acache, mesh)
        cache = tree_map(lambda x: x.shard(mesh.coords),
                         sharding.place_abstract(acache, named(cspecs)))
        if shape.step_kind == "prefill":
            meta = model.prefill_batch_specs(shape)
        else:
            meta = {"tokens": model.decode_token_specs(shape)}
        bspecs = sharding.batch_specs(cfg, meta, mesh)
        batch = {k: _zeros(v, dev) for k, v in meta.items()}
        args = _tree_bytes(params) + _tree_bytes(
            sharding.place_abstract(meta, named(bspecs)))
        if model.is_encdec:
            par = EncDecParallel(model, mesh, local_cache=True)
        else:
            par = TensorParallel(model, mesh, local_cache=True)

        def run():
            shards = gathered_shards(params, mesh)
            if model.is_encdec:
                if shape.step_kind == "prefill":
                    return par.prefill(shards, batch["frames"],
                                       batch["tokens"], cache)[0]
                return par.decode_step(shards, batch["tokens"], cache)[0]
            lps = par.layer_params(shards)
            if shape.step_kind == "prefill":
                return par.prefill(lps, batch["tokens"], cache,
                                   split_rows=True)[0]
            return par.decode_step(lps, batch["tokens"], cache)[0]

        with torch.inference_mode():
            return _lower(mesh, run, args, _tree_bytes(cache))


def _costs(lowered: Lowered) -> Dict[str, float]:
    out = {"flops": lowered.flops, "bytes": lowered.bytes}
    for kind, b in lowered.collectives.items():
        out[f"coll/{kind}"] = out.get(f"coll/{kind}", 0.0) + b
    return out


def _measures(lowered: Lowered) -> Dict[str, float]:
    """The costs and the footprint, as one extrapolated dict."""
    return dict(_costs(lowered), **{
        f"mem/{k}": float(getattr(lowered, f"{k}_bytes"))
        for k in ("arg", "temp", "out")})


def _lowered(totals: Dict[str, float]) -> Lowered:
    """A :class:`Lowered` from extrapolated :func:`_measures`."""
    return Lowered(flops=totals.get("flops", 0.0),
                   bytes=totals.get("bytes", 0.0),
                   collectives={k.split("/", 1)[1]: v
                                for k, v in totals.items()
                                if k.startswith("coll/")},
                   **{f"{k}_bytes": int(round(totals.get(f"mem/{k}", 0.0)))
                      for k in ("arg", "temp", "out")})


def extrapolate(cfg: ModelConfig, lower, base: int = 1) -> Dict[str, float]:
    """The reference's affine extrapolation: ``lower(variant cfg)`` ->
    costs at every block type's count ``base`` (1, the reference's), then
    at ``base + 1`` for each type in turn; the totals at
    ``block_counts(cfg)``."""
    counts = block_counts(cfg)
    base_pt = {k: base for k in counts}
    points = [base_pt] + [dict(base_pt, **{k: base + 1}) for k in counts]
    costs = [lower(with_counts(cfg, pt, scan=False)) for pt in points]
    keys = sorted({k for c in costs for k in c})
    totals: Dict[str, float] = {}
    for key in keys:
        f0 = costs[0].get(key, 0.0)
        total = f0
        for i, bname in enumerate(counts):
            coef = costs[i + 1].get(key, 0.0) - f0
            total += coef * (counts[bname] - base)
        totals[key] = max(total, 0.0)
    return totals


# the footprint's extrapolation starts at 2 layers a block type: the
# temporaries' peak of a stack's second layer holds what the first left
# (its output beside the second's transients), which a first layer has no
# predecessor to leave, so from 1 to 2 layers the peak grows by more than a
# layer's share and is affine only from 2 on
FOOTPRINT_BASE = 2


def extrapolate_cell(cfg: ModelConfig, lower) -> Dict[str, float]:
    """Costs from the unit-depth variants (the reference's points) and the
    footprint from :data:`FOOTPRINT_BASE` on, each variant lowered once
    (``lower(variant cfg)`` -> :func:`_measures`)."""
    done: Dict[tuple, Dict[str, float]] = {}

    def once(c):
        key = tuple(sorted(block_counts(c).items()))
        if key not in done:
            done[key] = lower(c)
        return done[key]

    totals = extrapolate(cfg, lambda c: {k: v for k, v in once(c).items()
                                         if not k.startswith("mem/")})
    totals.update(extrapolate(
        cfg, lambda c: {k: v for k, v in once(c).items()
                        if k.startswith("mem/")}, base=FOOTPRINT_BASE))
    return totals


# ---------------------------------------------------------------------------
# per-cell dry-run
# ---------------------------------------------------------------------------

OPT_BUNDLE = {  # the §Perf optimization bundle, per step kind
    "train": dict(attention_chunk=512, loss_chunk=512, microbatches=8),
    "prefill": dict(attention_chunk=512),
    "decode": dict(decode_cache_carry=True),
}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               verbose: bool = True, cfg_override: ModelConfig | None = None,
               optimized: bool = False, device="cuda"):
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    if optimized:
        cfg = dataclasses.replace(
            cfg, parallel=dataclasses.replace(cfg.parallel,
                                              **OPT_BUNDLE[shape.step_kind]))
    ok, why = shape_applicable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": True, "reason": why}

    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    n_chips = mesh.size

    # every variant must lower; costs and footprint extrapolated affinely
    # in the block counts
    seconds = []

    def lower(c):
        low = lower_step(c, shape, mesh)
        seconds.append(low.seconds)
        return _measures(low)

    cell = analyze(_lowered(extrapolate_cell(cfg, lower)), arch=arch,
                   shape=shape_name, mesh_name=mesh_name, n_chips=n_chips,
                   model_flops=model_flops_for(cfg, shape))
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] lowered OK "
              f"({len(seconds)} shallow variants in {sum(seconds):.1f}s "
              f"host, fake {mesh.device.type} tensors)")
        print(f"  footprint: args+out={cell.arg_bytes + cell.out_bytes:.3e}B "
              f"temp={cell.temp_bytes:.3e}B fits_80GB_HBM={cell.fits_hbm}")
        print(f"  costs (extrapolated): flops/dev={cell.flops_per_dev:.3e} "
              f"bytes/dev={cell.bytes_per_dev:.3e} "
              f"coll_bytes/dev={cell.collective_bytes_per_dev:.3e}")
        print(f"  roofline: compute={cell.compute_s * 1e3:.2f}ms "
              f"memory={cell.memory_s * 1e3:.2f}ms "
              f"collective={cell.collective_s * 1e3:.2f}ms -> {cell.bound}-bound "
              f"fraction={cell.roofline_fraction:.3f} "
              f"useful_flops={cell.useful_flops_ratio:.2f}")
    return cell


def default_out(multi_pod: bool) -> str:
    return ("results/torch_dryrun_multi_pod.json" if multi_pod
            else "results/torch_dryrun_single_pod.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="apply the §Perf optimization bundle per step kind")
    ap.add_argument("--out", default=None,
                    help="resumable JSON record file (default with --all: "
                         "results/torch_dryrun_{single,multi}_pod.json)")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors name (nothing is "
                         "allocated; no card is needed)")
    args = ap.parse_args(argv)

    cells = ([(a, s) for a in ASSIGNED for s in SHAPES] if args.all
             else [(args.arch, args.shape)])

    results = []
    out_name = args.out or (default_out(args.multi_pod) if args.all else None)
    out = Path(out_name) if out_name else None
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    if out and out.exists():
        results = json.loads(out.read_text())
        done = {(r["arch"], r["shape"], r.get("mesh")) for r in results}
        cells = [c for c in cells if (c[0], c[1], mesh_name) not in done]

    failures = 0
    for arch, shape in cells:
        t0 = time.time()
        try:
            cell = lower_cell(arch, shape, multi_pod=args.multi_pod,
                              optimized=args.opt, device=args.device)
            rec = cell if isinstance(cell, dict) else cell.to_dict()
        except Exception as e:  # a failure here is a bug in our sharding
            failures += 1
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                   "error": str(e)[:500]}
        rec["compile_s"] = time.time() - t0
        results.append(rec)
        if out:
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(results, indent=1))
        print(f"  ({rec['compile_s']:.1f}s)\n", flush=True)

    print(f"dry-run complete: {len(results)} records, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
