"""The comparison that decides ``correct``: served tokens against the plain
reference.

After the window, a sample of the finished requests (the one with the most
served tokens, and others drawn from the seed across the slots) is run once through the
reference, teacher-forced over its prompt and served tokens.  At each
served position the gap is how far the served token's reference logit lies
below the reference's best; the number compared is the widest gap.  It is
valid for greedy tokens, which is all the engine serves.  The control reads
at each position the gap of the token that the control's lower precision
puts first.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def sample(finished: List, k: int, seed: int) -> List:
    """The finished record with the most served tokens (then the longest
    prompt) and ``k - 1`` others drawn from ``seed``, each from a slot that
    no record drawn before it was served in while there are such."""
    if not finished:
        return []
    order = sorted(finished, key=lambda r: (len(r.seq.generated),
                                            len(r.seq.prompt)), reverse=True)
    rest = order[1:]
    rng = np.random.default_rng([seed, 7])
    seen = {order[0].slot}
    fresh, again = [], []
    for i in rng.permutation(len(rest)):
        rec = rest[int(i)]
        (again if rec.slot in seen else fresh).append(rec)
        seen.add(rec.slot)
    return [order[0]] + (fresh + again)[:k - 1]


def gaps(ref, recs: List, vocab: int, control=None,
         prefix_len: int = 0) -> Dict:
    """Widest gap over every served token of ``recs`` (and the control's,
    when given).  ``bad`` counts served ids outside the vocabulary and
    requests that served another count of tokens than they asked for.
    Requests of one tenant open with the same ``prefix_len`` tokens, whose
    K/V each side computes once (``Reference.prefix``)."""
    out: Dict = {"max_gap": 0.0, "tokens": 0, "bad": 0, "requests": len(recs)}
    if control is not None:
        out["control_gap"] = 0.0
    device = ref.params["embed"].device
    pasts: Dict = {}                       # the current tenant's, a side

    def past(side, rec):
        if rec.req.tenant is None or len(rec.seq.prompt) <= prefix_len:
            return None
        if id(side) not in pasts:
            pasts[id(side)] = side.prefix(torch.tensor(
                rec.seq.prompt[:prefix_len], device=device))
        return pasts[id(side)]

    tenant = None
    for rec in sorted(recs, key=lambda r: (r.req.tenant is None,
                                           r.req.tenant or 0)):
        if rec.req.tenant != tenant:
            tenant = rec.req.tenant
            pasts.clear()
        prompt, served = rec.seq.prompt, rec.seq.generated
        if len(served) != rec.seq.max_new_tokens or any(
                not 0 <= t < vocab for t in served):
            out["bad"] += 1
            continue
        toks = torch.tensor(prompt + served[:-1], device=device)
        got = torch.tensor(served, device=device)
        lg = ref.logits(toks, len(prompt) - 1, past(ref, rec))
        best = lg.max(-1).values
        gap = (best - lg.gather(1, got[:, None])[:, 0]).max().item()
        out["max_gap"] = max(out["max_gap"], gap)
        out["tokens"] += len(served)
        if control is not None:
            pick = control.logits(toks, len(prompt) - 1,
                                  past(control, rec)).argmax(-1)
            cg = (best - lg.gather(1, pick[:, None])[:, 0]).max().item()
            out["control_gap"] = max(out["control_gap"], cg)
        del lg
    return out
