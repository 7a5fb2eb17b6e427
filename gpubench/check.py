"""The comparison that decides ``correct``.

Serving: the reference runs once over each sampled request's prompt
followed by the tokens the engine served, and at each served token
reads how far that token's logit lies below the reference's best at
that position.  The widest such gap over the sample is the number
compared (``logit_gap``): greedy decoding serves the program's best
token, which may differ from the reference's only where the two best
logits lie closer than the program's rounding.

The control (``control=True``) is put in the program's place: the
same reference with every matmul's operands rounded to float8 e4m3
(one scale per tensor) ranks its own first token at every position of
the same sequences, and that token's gap is what ``logit_gap`` reads.
Judged by the cell's limit, a run with the control must come out not
correct.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import weights
from .reference import model as ref


def served_gaps(cfg: Dict, seed: int, samples: List[Dict], device,
                control: bool = False) -> Dict[str, Optional[float]]:
    """``logit_gap`` and the tokens it was read over, for *samples*
    (dicts of ``prompt`` and ``served`` ids): the reference's weights
    made again from *seed* on *device*.  With *control* the control's
    tokens are judged in place of the served ones."""
    if not samples:
        return dict(logit_gap=None, tokens=0)
    ref.tf32_off()
    flat, norms = weights.make(cfg, seed, device, torch.bfloat16)
    table = weights.leaves(cfg, flat, norms)
    seqs, want, served = [], [], []
    for s in samples:
        ids = list(s["prompt"]) + list(s["served"][:-1])
        p = len(s["prompt"])
        seqs.append(torch.tensor(ids, dtype=torch.long, device=device))
        want.append(torch.arange(p - 1, p - 1 + len(s["served"]),
                                 device=device))
        served.append(torch.tensor(s["served"], dtype=torch.long,
                                   device=device))
    with torch.no_grad():
        logits = ref.forward_logits(cfg, table.__getitem__, seqs, want)
        if control:
            low = ref.forward_logits(cfg, table.__getitem__, seqs, want,
                                     quant=ref.fp8_e4m3)
            served = [lo.argmax(-1) for lo in low]
        gaps = [(lg.max(-1).values
                 - lg.gather(1, tok[:, None])[:, 0]).max()
                for lg, tok in zip(logits, served)]
        out = dict(logit_gap=float(torch.stack(gaps).max()),
                   tokens=sum(len(t) for t in served))
    del flat, norms, table
    return out
