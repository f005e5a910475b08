"""The port's ``PlusTranscript.absorb_scalar``, ``absorb_tag`` and
``short_challenges`` against the JAX package's class: the same calls on
fresh transcripts of each power-of-two ring must leave the same sponge
state (``snapshot_state``) after every call and give the same challenges.
Tolerance: exact equality -- sponge words and challenges are integers."""

import pytest

from latticefold_torch.plus import PlusTranscript as TPlusTranscript
from latticefold_torch.rings.construct import get_ring as tget_ring
from latticefold_tpu.plus import PlusTranscript
from latticefold_tpu.rings.construct import get_ring


def _state(t):
    state, index, absorbing = t.snapshot_state()
    return [int(x) for x in state], int(index), bool(absorbing)


@pytest.mark.parametrize("name", ["frog", "stark"])
def test_plus_transcript_scalar_tag_short_challenges_match_jax(name):
    ring, tring = get_ring(name), tget_ring(name)
    jt, tt = PlusTranscript(ring), TPlusTranscript(tring)
    steps = [
        ("absorb_scalar", (7,)),
        ("absorb_scalar", (ring.q - 1,)),
        ("absorb_scalar", (ring.q + 5,)),  # reduced mod q
        ("absorb_tag", (b"latticefold-plus",)),
        ("absorb_tag", (b"\xff" * 40,)),  # a tag past q
        ("short_challenges", (3,)),
        ("absorb_scalar", (123456789,)),
        ("short_challenges", (2, 64)),
        ("get_challenge", ()),
    ]
    for method, args in steps:
        want = getattr(jt, method)(*args)
        got = getattr(tt, method)(*args)
        assert got == want, (method, args)
        assert _state(tt) == _state(jt), (method, args)
        if method == "short_challenges":
            assert len(got) == args[0] and all(len(c) == ring.d for c in got)
