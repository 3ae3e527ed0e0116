"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed and the program is freed, a sample of the
requests the engine finished, drawn from the seed (the longest of them,
then others from slots not yet in the sample), goes through the family's
plain f32 reference over its prompt and served tokens (teacher-forced).
At each served position the gap is how far the served token's reference
logit lies below the reference's best, in units of the reference logits'
standard deviation at that position. A greedy engine that computes what
the model states serves the reference's best token or one within its own
rounding of it. Two numbers are compared: the widest gap over the sample,
and the mean gap over its served positions (0 where the served token is
the reference's best), which grows with the square of the program's
error (more tokens flip, each by more) and so parts a lower precision
from rounding more widely than the widest gap does.

The fp8 control (``control_gaps``) reads, at the same positions, the gap
of the token that the reference computed in fp8 puts first.
"""

from __future__ import annotations

import numpy as np
import torch


def sample(done: list, seed: int, requests: int) -> list:
    """(prompt, output, slot) of finished requests -> ``requests`` of them:
    the longest (prompt and output) first, then the others in an order
    drawn from the seed, each from a slot not yet in the sample while
    there are such."""
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: (len(done[i][0]) + len(done[i][1]), -i))
    rest = [i for i in np.random.default_rng([seed, 5]).permutation(
        len(done)).tolist() if i != longest]
    picked, slots = [longest], {done[longest][2]}
    for fresh in (True, False):
        for i in rest:
            if len(picked) == requests:
                break
            if i not in picked and (done[i][2] not in slots) == fresh:
                picked.append(i)
                slots.add(done[i][2])
    return [done[i] for i in picked]


def _inputs(picked):
    seqs, positions = [], []
    for prompt, out, _ in picked:
        seqs.append(list(prompt) + list(out[:-1]))
        positions.append(list(range(len(prompt) - 1,
                                    len(prompt) + len(out) - 1)))
    return seqs, positions


def _gap(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    best = ref.max(dim=-1).values
    chosen = ref.gather(-1, tokens[:, None])[:, 0]
    return (best - chosen) / ref.std(dim=-1)


def served_gaps(reference, cfg, raw, picked, device) -> np.ndarray:
    """The gap of every served token of ``picked``."""
    seqs, positions = _inputs(picked)
    refs = reference.logits(cfg, raw, seqs, positions, device)
    gaps = [_gap(r, torch.as_tensor(out, device=device))
            for r, (_, out, _) in zip(refs, picked)]
    return torch.cat(gaps).cpu().numpy() if gaps else np.zeros(0)


def control_gaps(reference, cfg, raw, picked, device,
                 act_dtype=torch.float8_e4m3fn) -> np.ndarray:
    """At the same positions, the gap of the token the reference computed
    at ``act_dtype`` puts first."""
    seqs, positions = _inputs(picked)
    refs = reference.logits(cfg, raw, seqs, positions, device)
    lows = reference.logits(cfg, raw, seqs, positions, device,
                            act_dtype=act_dtype)
    gaps = [_gap(r, low.argmax(dim=-1)) for r, low in zip(refs, lows)]
    return torch.cat(gaps).cpu().numpy() if gaps else np.zeros(0)
