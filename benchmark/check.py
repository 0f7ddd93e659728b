"""What decides `correct`: the served greedy tokens against the reference.

After the window has closed, a sample of the greedy requests that the run
finished, drawn from the seed and always holding the one with the most
served tokens, is run through the plain reference (reference.py) as one
sequence each, its prompt and its served tokens. The number compared is the
widest gap by which a served token's reference logit lies below the
reference's best at its position (`max_gap`), or their mean (`mean_gap`),
whichever the cell's limits name. The control (`control=True`) reads, at the
same positions, the gap of the token that the reference one precision step
down (reference.py) puts first. Positions whose router decision is a tie in
the reference (an MoE model; reference.ROUTER_TIE) are left out of both: a
last-bit difference may route them to other experts, which is no fault.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from benchmark import reference
from benchmark.window import Record


def sample(records: List[Record], n: int, seed: int) -> List[Record]:
    done = [r for r in records if r.greedy and r.tokens and not r.failed]
    if not done:
        return []
    done.sort(key=lambda r: r.index)
    longest = max(done, key=lambda r: len(r.tokens))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed), 11])
    pick = list(rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def readings(model: dict, chosen: List[Record], prompts: dict, device,
             control: bool = False, kv_dtype: str = "bf16") -> dict:
    """{"max_gap", "tokens_checked", "requests_checked"} of the chosen
    requests, and with `control` the control's "control_gap"."""
    seqs, served = [], []
    for r in chosen:
        ids = np.concatenate([prompts[r.index], np.asarray(r.tokens[:-1], np.int64)])
        seqs.append(torch.as_tensor(ids, dtype=torch.long, device=device))
        served.append(r.tokens)
    out = dict(requests_checked=len(chosen), tokens_checked=sum(len(s) for s in served))
    if not chosen:
        return out
    with torch.no_grad():
        ties = []
        ref = reference.forward(model, seqs, ties=ties)
        keep = [~t[len(prompts[r.index]) - 1:len(prompts[r.index]) - 1 + len(r.tokens)]
                for t, r in zip(ties, chosen)]
        gaps = torch.cat([reference.served_gaps(lg, len(prompts[r.index]), r.tokens)[k]
                          for lg, r, k in zip(ref, chosen, keep)])
        out["router_ties_left_out"] = int(sum(int((~k).sum()) for k in keep))
        out["tokens_checked"] -= out["router_ties_left_out"]
        out["max_gap"] = float(gaps.max()) if gaps.numel() else None
        out["mean_gap"] = float(gaps.mean()) if gaps.numel() else None
        if control:
            low = reference.forward(model, seqs, low=True, kv_dtype=kv_dtype)
            cg = torch.cat([reference.control_gaps(a, b, len(prompts[r.index]),
                                                   len(r.tokens))[k]
                            for a, b, r, k in zip(ref, low, chosen, keep)])
            out["control_gap"] = float(cg.max()) if cg.numel() else None
            out["control_mean_gap"] = float(cg.mean()) if cg.numel() else None
    return out


GAPS = ("max_gap", "mean_gap")  # the numbers a cell's limits file may hold to a ceiling


def verdict(found: dict, limits: dict) -> tuple:
    """(correct, the numbers compared with their limits): each gap the cell's
    limits name at or below its limit, and at least `min_tokens_checked`
    tokens checked."""
    compared, ok = {}, True
    for name in GAPS:
        if name in limits:
            value: Optional[float] = found.get(name)
            compared[name] = {"value": value, "limit": limits[name]}
            ok = ok and value is not None and value <= limits[name]
    n = found.get("tokens_checked", 0)
    compared["tokens_checked"] = {"value": n, "limit": limits["min_tokens_checked"]}
    return ok and n >= limits["min_tokens_checked"], compared
