"""Faults a one-card serving cell can have, planted underneath the timed
path for the check to catch: ``hooks`` for ``harness.run_cell``
(``perfbench/calibrate.py --fault <name>`` on the card, the rehearsal
tests on the CPU)."""

import numpy as np


def altered_tokens(eng):
    """A token altered where it is produced: every burst's last step."""
    orig = eng._decode

    def decode(active, burst):
        trace = orig(active, burst)
        trace[-1] = (trace[-1] + 1) % 512
        return trace
    eng._decode = decode


def half_batch(eng):
    """Half of the active rows left out of each decode step (their token
    stays the previous one)."""
    orig = eng._decode

    def decode(active, burst):
        live = np.flatnonzero(active)
        kept = active.copy()
        kept[live[len(live) // 2:]] = False
        return orig(kept, burst)
    eng._decode = decode


def state_unchanged(eng):
    """A decode step that returns its state unchanged: the tokens it
    starts from."""
    orig = eng._decode

    def decode(active, burst):
        before = eng.tokens.clone()
        orig(active, burst)
        eng.tokens = before
        return np.repeat(before.cpu().numpy()[None], burst, axis=0)
    eng._decode = decode


FAULTS = {f.__name__: f for f in (altered_tokens, half_batch,
                                  state_unchanged)}
