"""The comparison that decides ``correct``.

After the window, a sample of the finished requests drawn from the seed
(the longest one always in it) is run through the float32 reference
(:mod:`reference.model`) once: each prompt with its served tokens.  At
every served position the reading is the gap by which the served token's
reference logit lies below the reference's best; the numbers are the
widest gap over the sample and the mean gap over its positions.  Greedy serving at the reference's
precision reads 0; the served bfloat16 path reads the rounding of its
activations, and a wrong token reads far more.  Every request must also
have been served whole (a missing one is ``failed``).

The control (:func:`control_gaps`) reads the same gaps for the tokens
that the reference computed with float8 activations puts first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from reference.model import Reference

# the numbers a configuration's ``check`` block can give a limit
NUMBERS = ("max_logit_gap", "mean_logit_gap")


def sample(finished: Sequence, k: int, seed: int) -> List:
    """``k`` finished requests drawn from the seed, the longest (prompt
    and served tokens) among them."""
    reqs = sorted(finished, key=lambda r: r.rid)
    if len(reqs) <= k:
        return reqs
    longest = max(reqs, key=lambda r: (len(r.prompt) + len(r.tokens), -r.rid))
    rest = [r for r in reqs if r is not longest]
    rng = np.random.default_rng([int(seed), 1])
    pick = rng.choice(len(rest), size=k - 1, replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def sequences(reqs: Sequence):
    """(token sequences, rows): each prompt followed by its served tokens,
    and the positions whose logits choose the served tokens."""
    seqs, rows = [], []
    for r in reqs:
        p, out = np.asarray(r.prompt), np.asarray(r.tokens, np.int64)
        seqs.append(torch.as_tensor(np.concatenate([p, out]),
                                    dtype=torch.int64))
        rows.append(range(len(p) - 1, len(p) - 1 + len(out)))
    return seqs, rows


def _gaps(ref: Sequence[torch.Tensor], toks) -> Dict[str, float]:
    """The widest and the mean gap between the reference's best logit and
    its logit of the chosen token, over every position."""
    gaps = torch.cat([lg.amax(dim=1) - lg.gather(1, t[:, None])[:, 0]
                      for lg, t in zip(ref, toks)])
    return {"max_logit_gap": float(gaps.max()),
            "mean_logit_gap": float(gaps.mean())}


def served_gaps(ref: Sequence[torch.Tensor], reqs: Sequence
                ) -> Dict[str, float]:
    """The gaps of the served tokens of ``reqs``."""
    return _gaps(ref, [torch.as_tensor(np.asarray(r.tokens, np.int64),
                                       device=lg.device)
                       for lg, r in zip(ref, reqs)])


def control_gaps(ref: Sequence[torch.Tensor],
                 low: Sequence[torch.Tensor]) -> Dict[str, float]:
    """The gaps of the tokens the lower precision puts first, read on the
    reference's logits."""
    return _gaps(ref, [b.argmax(dim=1) for b in low])


def run(conf: Dict, seed: int, finished: Sequence, device) -> Dict:
    """The sample's readings (``max_logit_gap``, ``mean_logit_gap``) and
    its size."""
    chk = conf["check"]
    reqs = sample(finished, int(chk["sample"]), seed)
    seqs, rows = sequences(reqs)
    ref = Reference(conf["model"], conf["quant"]["bits"], seed, device)
    out = served_gaps(ref.logits_at(seqs, rows), reqs)
    out.update(sampled=len(reqs),
               served_tokens=int(sum(len(r.tokens) for r in reqs)),
               longest=int(max((len(s) for s in seqs), default=0)))
    return out
