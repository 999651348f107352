"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, a sample of
the requests the client received in full is drawn from the seed, with the
longest of them in it, until it holds ``min_tokens`` served tokens and
``min_requests`` requests. The
plain reference runs once over each request's prefill bucket (the prompt
left-padded with token 0, as the served path lays it out) followed by its
served tokens, and reads the logits at every position that chose a served
token: the last prompt position (the prefill's token) and each decode
step's. The number compared is the widest gap by which a served token's
reference logit lies below the reference's best there. Greedy decoding
with every layer right gives gaps of rounding size; a wrong weight, a
wrong prefill, a wrong decode through the paged cache or an altered token
on the way to the client gives gaps of the logits' own size.

The control puts the reference in the program's place at the precision
below the configuration's bf16: every weight matrix rounded to fp8 e4m3
with a scale per output channel (over the input axes the reference's
leaf table declares; vectors pass unchanged). At each position of the
same sequences it reads the gap of the token the fp8 reference puts
first; a run with ``control`` judges that gap against the cell's limit in
the served tokens' place.
"""

from __future__ import annotations

import functools
import time
from typing import List, Sequence

import numpy as np
import torch

from teebench import weights

FP8_MAX = 448.0


def sample(records, seed: int, min_tokens: int, min_requests: int,
           max_requests: int, t_end: float) -> List:
    """Requests received in full before ``t_end``: the longest (most
    served tokens, then the longest prompt), then others in an order drawn
    from the seed, until ``min_tokens`` served tokens and ``min_requests``
    requests, or ``max_requests``."""
    done = [r for r in records
            if r.finished and not r.failed and r.times[-1] <= t_end]
    if not done:
        return []
    done.sort(key=lambda r: (len(r.tokens), len(r.spec.prompt),
                             -r.spec.client), reverse=True)
    picked, rest = [done[0]], done[1:]
    order = np.random.default_rng([int(seed) & ((1 << 64) - 1), 9]
                                  ).permutation(len(rest))
    tokens = len(done[0].tokens)
    for i in order:
        if len(picked) >= max_requests or (
                tokens >= min_tokens and len(picked) >= min_requests):
            break
        picked.append(rest[i])
        tokens += len(rest[i].tokens)
    return picked


def sequence(rec) -> (np.ndarray, tuple):
    """(tokens the reference runs over, [start, stop) of the positions
    whose logits chose the served tokens)."""
    pad = rec.bucket - len(rec.spec.prompt)
    served = rec.tokens[:rec.spec.max_new_tokens]
    seq = np.concatenate([np.zeros(pad, np.int64),
                          rec.spec.prompt.astype(np.int64),
                          np.asarray(served[:-1], np.int64)])
    start = rec.bucket - 1
    return seq, (start, start + len(served))


def served_gaps(ref_logits: Sequence[torch.Tensor], served) -> np.ndarray:
    """Per position: the reference's best logit less its logit of the
    served token."""
    out = []
    for lg, toks in zip(ref_logits, served):
        idx = torch.as_tensor(np.asarray(toks), dtype=torch.long,
                              device=lg.device)
        best = lg.max(dim=-1).values
        out.append((best - lg.gather(1, idx[:, None])[:, 0]).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def control_gaps(ref_logits, ctrl_logits) -> np.ndarray:
    """Per position: the gap of the token the control puts first."""
    return served_gaps(ref_logits, [lg.argmax(dim=-1).cpu().numpy()
                                    for lg in ctrl_logits])


def fp8_weights(cfg: dict, leaf: str, w: torch.Tensor) -> torch.Tensor:
    """One layer's ``w`` rounded to fp8 e4m3 with an absmax scale per
    output channel, over the input axes ``cfg``'s leaf table declares (a
    leaf with none, a norm scale, passes unchanged)."""
    axes = weights.describe(cfg, leaf).inputs
    if not axes:
        return w
    scale = w.abs().amax(dim=axes, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def compare(reference, cfg: dict, seed: int, picked, *, device,
            control: bool = False) -> dict:
    """The program's widest gap over the picked requests (and the
    control's, when asked). Returns gaps, tokens compared and seconds."""
    start = time.perf_counter()
    seqs, reads, served = [], [], []
    for rec in picked:
        seq, rd = sequence(rec)
        seqs.append(seq)
        reads.append(rd)
        served.append(rec.tokens[:rec.spec.max_new_tokens])
    ref = reference.logits(cfg, seed, seqs, reads, device=device)
    gaps = served_gaps(ref, served)
    out = {"max_logit_gap": float(gaps.max()) if gaps.size else None,
           "tokens_compared": int(gaps.size),
           "requests_compared": len(picked),
           "positions_off_greedy": int((gaps > 0).sum())}
    if control:
        ctrl = reference.logits(cfg, seed, seqs, reads, device=device,
                                weight_fn=functools.partial(fp8_weights,
                                                            cfg))
        cg = control_gaps(ref, ctrl)
        out["control_max_logit_gap"] = float(cg.max()) if cg.size else None
        out["control_positions_off"] = int((cg > 0).sum())
    out["seconds"] = time.perf_counter() - start
    return out
