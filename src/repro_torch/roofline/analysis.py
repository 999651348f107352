"""Roofline terms of a step (port of ``repro.roofline.analysis``).

Terms per device, at the H100's rates:
    compute    = FLOPs / PEAK_FLOPS                  (989 TFLOP/s bf16)
    memory     = bytes / core.overheads.HBM_BYTES_PER_S
    collective = link bytes / core.overheads.LINK_BYTES_PER_S

The rates of device memory and of the link are read from
``repro_torch.core.overheads`` when a cell is built, so the port has one
source for each. ``model_flops_for`` counts MODEL_FLOPS (6ND for a train
step, 2ND for inference), the numerator of a step's utilisation.
Collective bytes are parsed from HLO text (``parse_collectives``): for each
all-gather / all-reduce / reduce-scatter / all-to-all / collective-permute
the RESULT shape, converted to bytes moved per device with the standard
ring factors:

    all-gather          result x (s-1)/s
    all-reduce          2 x result x (s-1)/s
    reduce-scatter      result x (s-1)          (operand = result x s)
    all-to-all          result x (s-1)/s
    collective-permute  result

where s = the replica-group size parsed from the op. The reference's
``analyze`` reads XLA's compiled object; the port's reads the dry run's
:class:`~repro_torch.launch.dryrun.Lowered` record (one rank's step under
fake tensors), whose collective bytes are the dry groups' own count of
what moves into one shard, with no ring factor applied.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

from repro_torch.core import overheads
from repro_torch.core.overheads import RooflineTerms

# -- hardware constants (NVIDIA H100 SXM5 80GB data sheet) ------------------
PEAK_FLOPS = 989e12          # bf16 dense FLOP/s per card
HBM_BYTES = 80 * 10**9       # device memory: 80 GB HBM3

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "c64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "f8e4m3fn": 1, "f8e5m2": 1, "s8": 1, "u8": 1, "pred": 1,
}

_COLL_FACTORS = {
    "all-gather": lambda s: (s - 1) / s,
    "all-reduce": lambda s: 2 * (s - 1) / s,
    "reduce-scatter": lambda s: float(s - 1),
    "all-to-all": lambda s: (s - 1) / s,
    "collective-permute": lambda s: 1.0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*(\([^)]*\)|\S+)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    moved_bytes: float


def parse_collectives(hlo_text: str) -> List[CollectiveOp]:
    ops: List[CollectiveOp] = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        if "-done" in line.split("=")[1][:60]:
            continue
        result, kind = m.group(1), m.group(2)
        rb = _shape_bytes(result)
        gm = _GROUPS_RE.search(line)
        if gm:
            group_size = int(gm.group(2))
        else:
            gl = _GROUPS_LIST_RE.search(line)
            group_size = len(gl.group(1).split(",")) if gl else 2
        moved = rb * _COLL_FACTORS[kind](max(group_size, 1))
        ops.append(CollectiveOp(kind, rb, group_size, moved))
    return ops


@dataclasses.dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_dev: float
    bytes_per_dev: float
    collective_bytes_per_dev: float
    collective_breakdown: Dict[str, float]
    arg_bytes: int
    temp_bytes: int
    out_bytes: int
    model_flops: float           # 6*N*D (or 6*N_active*D) global
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def __post_init__(self):
        self.compute_s = self.flops_per_dev / PEAK_FLOPS
        self.memory_s = self.bytes_per_dev / overheads.HBM_BYTES_PER_S
        self.collective_s = (self.collective_bytes_per_dev
                             / overheads.LINK_BYTES_PER_S)

    @property
    def terms(self) -> RooflineTerms:
        return RooflineTerms(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bound(self) -> str:
        return self.terms.bound

    @property
    def step_s(self) -> float:
        """Roofline step time: dominant term (perfect overlap assumption)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction: time the chip would spend on MODEL_FLOPS
        at peak, over the roofline step time."""
        ideal = self.model_flops / (self.n_chips * PEAK_FLOPS)
        return ideal / self.step_s if self.step_s > 0 else 0.0

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_dev * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def bw_fraction(self) -> float:
        """Decode-cell roofline: ideal time to stream the per-device resident
        state (params + cache = the compiled argument bytes) once from HBM,
        over the achieved step time. The right metric where useful-FLOPs is
        inherently tiny (one token per sequence)."""
        ideal = self.arg_bytes / overheads.HBM_BYTES_PER_S
        return ideal / self.step_s if self.step_s > 0 else 0.0

    @property
    def hbm_bytes_per_dev(self) -> int:
        return self.arg_bytes + self.temp_bytes + self.out_bytes

    @property
    def fits_hbm(self) -> bool:
        return self.hbm_bytes_per_dev <= HBM_BYTES

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(bound=self.bound, step_s=self.step_s,
                 roofline_fraction=self.roofline_fraction,
                 useful_flops_ratio=self.useful_flops_ratio,
                 bw_fraction=self.bw_fraction,
                 hbm_bytes_per_dev=self.hbm_bytes_per_dev,
                 fits_hbm=self.fits_hbm)
        return d


def analyze(lowered, *, arch: str, shape: str, mesh_name: str, n_chips: int,
            model_flops: float) -> CellRoofline:
    """The roofline of a cell from the dry run's ``Lowered`` record, at the
    H100's rates."""
    breakdown = {k: float(v) for k, v in lowered.collectives.items()}
    return CellRoofline(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n_chips,
        flops_per_dev=float(lowered.flops),
        bytes_per_dev=float(lowered.bytes),
        collective_bytes_per_dev=float(sum(breakdown.values())),
        collective_breakdown=breakdown,
        arg_bytes=int(lowered.arg_bytes),
        temp_bytes=int(lowered.temp_bytes),
        out_bytes=int(lowered.out_bytes),
        model_flops=model_flops,
    )


def _encdec_split(cfg) -> Tuple[float, float]:
    """(enc_params, dec_params) excluding embeddings (counted decoder-side)."""
    d, hd = cfg.d_model, cfg.head_dim_
    attn = (d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
            + cfg.num_heads * hd * d)
    ffn = 2 * d * cfg.d_ff
    enc = cfg.encoder_layers * (attn + ffn)
    dec = cfg.decoder_layers * (2 * attn + ffn) + cfg.vocab_size * d
    return float(enc), float(dec)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D for train (fwd+bwd), 2*N*D for inference steps.
    N = active params; D = tokens processed by the step. Enc-dec models split
    the params by which token stream they actually process."""
    total, active = cfg.params_count()
    mult = 6.0 if shape.step_kind == "train" else 2.0
    if cfg.family == "encdec":
        enc_p, dec_p = _encdec_split(cfg)
        enc_tok = shape.global_batch * shape.seq_len
        if shape.step_kind == "decode":
            # one decoder token; cross-attn reads cached enc states (memory,
            # not flops); encoder not run.
            return 2.0 * dec_p * shape.global_batch
        dec_tok = shape.global_batch * cfg.max_target_len
        return mult * (enc_p * enc_tok + dec_p * dec_tok)
    if shape.step_kind == "decode":
        return 2.0 * active * shape.global_batch
    return mult * active * shape.global_batch * shape.seq_len
