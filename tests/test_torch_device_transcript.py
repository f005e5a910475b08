"""The port's device-resident transcript (``latticefold_torch.transcript.device``)
and the provers on it (``sumcheck.trace_prove``, ``plus.sumcheck.prove_device``)
against the JAX package, on the CPU (the plain permutation).

- ``TraceSponge`` on the mixed absorb / squeeze schedule of
  tests/test_device_transcript.py:26-66 (an export after a warm-up, 37
  absorbs, 25 squeezes, a challenge, a re-import into a fresh transcript),
  against the JAX package's host ``Transcript``, its ``export_state`` and
  ``import_state``, at Goldilocks; and against the port's own host
  ``Transcript`` at all four rings, on a schedule that rests at index ==
  rate and switches modes. The JAX package's ``TraceSponge`` itself is not
  run: its permutation takes minutes a call on XLA:CPU (its own test above
  holds it to the same host transcript).
- The sponge kernel's call-level schedule (``call_segments`` / ``call_plan``,
  run by its plain version ``sponge_call_plain``; the kernel's
  csrc/poseidon.cuh ``lf_call_seg`` is held to the host sponge by
  tests/test_torch_csrc_poseidon.py) against the JAX package's
  ``TraceSponge`` on absorb and squeeze calls at mode switches, with
  trailing chunks, from a full rate and with 0 permutations, the
  permutation replaced in both by one stand-in (a rotation of the state's
  words): each call's permutations, index, mode, state and squeezed
  values, and ``GhostSponge``'s permutation and launch counts.
- ``short_challenge_trace`` against ``get_short_challenge`` at all four rings;
  ``GhostSponge`` trajectories against the JAX package's (a sumcheck
  round's schedule against its ``sp_ghost_round``), and its permutation
  count against the device sponge's permutations.
- ``sumcheck.trace_prove`` over a device sponge exported from a host
  transcript, against the JAX package's ``sumcheck.prove_host`` on seeded
  degree-3 tables: the proof, the challenges, the final values and the
  transcript state afterwards.
- ``plus.sumcheck.prove_device`` against the JAX package's
  ``plus.sumcheck.prove_host`` in scalar and ring mode on Frog, and
  ``plus.sumcheck.prove`` taking the host prover for CPU tables.

Inputs are made with numpy from seeds. Tolerance: exact equality -- every
value is an integer mod q."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticefold_torch import convert
from latticefold_torch import modops as tmo
from latticefold_torch import sumcheck as tsc
from latticefold_torch.plus import PlusTranscript as TPlusTranscript
from latticefold_torch.plus import sumcheck as tpsc
from latticefold_torch.rings import ops as tops
from latticefold_torch.rings.construct import get_ring as tget_ring
from latticefold_torch.transcript import Transcript as TTranscript
from latticefold_torch.transcript import device as tdtr
from latticefold_tpu import modops as jmo
from latticefold_tpu import sumcheck as jsc
from latticefold_tpu.plus import PlusTranscript
from latticefold_tpu.plus import sumcheck as jpsc
from latticefold_tpu.rings import ops as jops
from latticefold_tpu.rings.construct import get_ring
from latticefold_tpu.transcript import Transcript
from latticefold_tpu.transcript import device as jdtr

CPU = torch.device("cpu")
RINGS = ["goldilocks", "babybear", "frog", "stark"]


def mont_tensor(ring, vals):
    """F_q ints -> their Montgomery limbs [n, nl] as a CPU tensor."""
    R = 1 << (32 * ring.nl)
    return convert.tensor(ring.fq.encode(np.array([v * R % ring.q for v in vals], dtype=object)), CPU)


def host_ints(ring, t):
    """Montgomery limbs [..., nl] -> canonical ints (a flat list)."""
    return [int(v) for v in ring.fq.decode(tmo.from_mont(ring.fq, t).numpy()).reshape(-1)]


def test_trace_sponge_matches_jax_schedule():
    name = "goldilocks"
    ring, tring = get_ring(name), tget_ring(name)
    host, port_host = Transcript(ring), TTranscript(tring)
    for t in (host, port_host):
        t.absorb_tag(b"warmup")
    host.absorb(ring.embed_int(12345))
    port_host.absorb(tring.embed_int(12345))

    state, idx, absorbing = jdtr.export_state(ring, host)
    tstate, tidx, tabsorbing = tdtr.export_state(tring, port_host, CPU)
    assert np.array_equal(convert.to_numpy(tstate), np.asarray(state)) and (tidx, tabsorbing) == (idx, absorbing)
    sp = tdtr.TraceSponge(tring, tstate, tidx, tabsorbing)

    rng = np.random.default_rng(7)
    vals1 = [int(v) for v in rng.integers(0, min(ring.q, 2**63), size=37)]
    host.sponge.absorb(vals1)
    sp.absorb(mont_tensor(tring, vals1))
    assert host_ints(tring, sp.squeeze(25)) == host.sponge.squeeze_native(25)
    # absorb-after-squeeze transition + challenge mechanics
    assert tuple(tdtr.k_from_device(tring, sp.get_challenge())) == host.get_challenge()

    # the JAX package's ghost knows the bookkeeping; the device state, read
    # into a fresh JAX transcript, continues the stream
    g = jdtr.GhostSponge(ring, idx, absorbing)
    g.absorb(37)
    g.squeeze(25)
    g.squeeze(ring.e)
    g.absorb(ring.e)
    assert (g.index, g.absorbing) == (sp.index, sp.absorbing)
    host2 = Transcript(ring)
    jdtr.import_state(ring, host2, jnp.asarray(convert.to_numpy(sp.state)), sp.index, sp.absorbing)
    assert host2.get_challenge() == host.get_challenge()
    assert host2.squeeze_bytes(18) == host.squeeze_bytes(18)


@pytest.mark.parametrize("name", RINGS)
def test_trace_sponge_matches_port_host(name):
    """Absorbs that fill the rate exactly (resting at index == rate), cross
    it, squeezes across a permutation, absorb after squeeze, ring elements,
    K elements and the re-import, against the port's host Transcript."""
    ring = tget_ring(name)
    host = TTranscript(ring)
    host.absorb_tag(b"dev")
    sp = tdtr.TraceSponge(ring, *tdtr.export_state(ring, host, CPU))
    ghost = tdtr.GhostSponge(ring, sp.index, sp.absorbing)
    perms = []
    permute = sp._permute
    sp._permute = lambda *a: perms.append(1) or permute(*a)
    rng = np.random.default_rng(ring.d)
    fill = sp.rate - sp.index
    for i, (n_abs, n_sq) in enumerate(((fill, 0), (13, 3), (20, 41), (0, 1), (45, 2))):
        vals = [int.from_bytes(rng.bytes(32), "little") % ring.q for _ in range(n_abs)]
        host.sponge.absorb(vals)
        sp.absorb(mont_tensor(ring, vals))
        ghost.absorb(n_abs)
        if i == 0:
            assert (sp.index, sp.absorbing) == (sp.rate, True)  # resting at the end of the rate
        assert host_ints(ring, sp.squeeze(n_sq)) == host.sponge.squeeze_native(n_sq)
        ghost.squeeze(n_sq)
        assert (sp.index, sp.absorbing) == tuple(host.snapshot_state()[1:]) == (ghost.index, ghost.absorbing)
        assert ghost.perms == len(perms)
    elt = tops.to_device(ring, [ring.embed_int(5), ring.one()], CPU)
    sp.absorb_ring(elt)
    host.absorb_slice([ring.embed_int(5), ring.one()])
    c = sp.get_challenge()
    assert tuple(tdtr.k_from_device(ring, c)) == host.get_challenge()
    sp.absorb_field_element(c)
    host.absorb_field_element(tuple(tdtr.k_from_device(ring, c)))
    fresh = TTranscript(ring)
    tdtr.import_state(ring, fresh, sp.state, sp.index, sp.absorbing)
    assert fresh.snapshot_state() == host.snapshot_state()


# (n, absorb): see tests/test_torch_csrc_poseidon.py's CALLS
SCHEDULE_CALLS = [(67, True), (5, True), (8, True), (21, True), (45, False), (3, False), (30, False), (2, True)]


def test_sponge_call_schedule_matches_jax(monkeypatch):
    name = "goldilocks"
    ring, tring = get_ring(name), tget_ring(name)
    perms = []
    monkeypatch.setattr(jdtr, "permute", lambda r, st: perms.append(1) or jnp.roll(st, 1, axis=0))

    def rot(st):
        return torch.roll(st, 1, 0)

    rng = np.random.default_rng(3)
    state = ring.fq.encode(rng.integers(0, 2**63, size=24).astype(object))
    idx, absorbing = 13, False
    jsp = jdtr.TraceSponge(ring, jnp.asarray(state), idx, absorbing)
    ghost = tdtr.GhostSponge(tring, idx, absorbing)
    tstate, launches = convert.tensor(state, CPU), 0
    for i, (n, absorb) in enumerate(SCHEDULE_CALLS):
        switch, before = absorbing != absorb, len(perms)
        if absorb:
            vals = ring.fq.encode(rng.integers(0, 2**63, size=n).astype(object))
            jsp.absorb(jnp.asarray(vals))
            tstate, _ = tdtr.sponge_call_plain(tring, tstate, convert.tensor(vals, CPU), n, idx, switch, rot)
            ghost.absorb(n)
        else:
            jout = jsp.squeeze(n)
            tstate, tout = tdtr.sponge_call_plain(tring, tstate, None, n, idx, switch, rot)
            assert np.array_equal(convert.to_numpy(tout), np.asarray(jout)), f"call {i}: squeezed values"
            ghost.squeeze(n)
        nperm, idx = tdtr.call_plan(n, idx, switch, jsp.rate)
        absorbing = absorb
        launches += absorb or nperm > 0
        assert nperm == len(perms) - before, f"call {i}: permutations"
        assert (idx, absorbing) == (jsp.index, jsp.absorbing) == (ghost.index, ghost.absorbing), f"call {i}"
        assert np.array_equal(convert.to_numpy(tstate), np.asarray(jsp.state)), f"call {i}: state"
    assert (ghost.perms, ghost.launches) == (len(perms), launches) == (11, 7)


@pytest.mark.parametrize("name", RINGS)
def test_short_challenge_matches_host(name):
    ring = tget_ring(name)
    host = TTranscript(ring)
    host.absorb_tag(b"rho_s")
    sp = tdtr.TraceSponge(ring, *tdtr.export_state(ring, host, CPU))
    for _ in range(3):
        got = tdtr.short_challenge_trace(sp)
        assert [int(v) for v in ring.fq.decode(got.numpy())] == host.get_short_challenge()
    assert tdtr.squeeze_bytes_trace(sp, 5).tolist() == list(host.squeeze_bytes(5))


@pytest.mark.parametrize("name", ["goldilocks", "frog"])
def test_ghost_sponge_matches_jax(name):
    ring, tring = get_ring(name), tget_ring(name)
    rng = np.random.default_rng(11)
    for idx0, abs0 in ((0, True), (20, True), (7, False), (20, False)):
        j, t = jdtr.GhostSponge(ring, idx0, abs0), tdtr.GhostSponge(tring, idx0, abs0)
        # n >= 1: a squeeze of 0 switches the JAX ghost's mode, the host
        # sponge's and the port's not (no prover squeezes 0)
        for op, n in zip(rng.integers(0, 2, size=40), rng.integers(1, 50, size=40)):
            getattr(j, ("absorb", "squeeze")[op])(int(n))
            getattr(t, ("absorb", "squeeze")[op])(int(n))
            assert (t.index, t.absorbing) == (j.index, j.absorbing)
        for degree in (3, 4):
            # one sumcheck round: the message, the challenge and its
            # re-absorb, and the challenge's ring embedding
            jsc.sp_ghost_round(j, ring, degree)
            for op, n in (("absorb", (degree + 1) * tring.d), ("squeeze", tring.e), ("absorb", tring.e),
                          ("absorb", tring.d)):
                getattr(t, op)(n)
            assert (t.index, t.absorbing) == (j.index, j.absorbing)


def _ring_tables(ring, nm, nvars, seed):
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, min(ring.q, 2**63), size=(nm, 1 << nvars, ring.ncomp, ring.e))
    return ring.fq.encode(ints.astype(object))


def test_sumcheck_trace_prove_matches_jax():
    name, nvars, degree = "goldilocks", 4, 3
    ring, tring = get_ring(name), tget_ring(name)
    tabs = _ring_tables(ring, 4, nvars, 3)

    def jfn(v, consts):
        return jops.ring_add(ring, jops.ring_mul(ring, jops.ring_mul(ring, v[0], v[1]), v[2]), v[3])

    def tfn(v, consts):
        return tops.ring_add(tring, tops.ring_mul(tring, tops.ring_mul(tring, v[0], v[1]), v[2]), v[3])

    jt, tt = Transcript(ring), TTranscript(tring)
    jt.absorb_tag(b"diff")
    tt.absorb_tag(b"diff")
    jp, jc, jf = jsc.prove_host(ring, jt, jnp.asarray(tabs), nvars, degree, jsc.CombFn(ring, jfn, "t:deg3"))
    sp = tdtr.TraceSponge(tring, *tdtr.export_state(tring, tt, CPU))
    evals, chals, tf = tsc.trace_prove(sp, convert.tensor(tabs, CPU), nvars, degree, tfn)
    tdtr.import_state(tring, tt, sp.state, sp.index, sp.absorbing)
    assert [list(r) for r in tops.to_host(tring, evals)] == jp.round_evals
    assert [tuple(c) for c in tdtr.k_from_device(tring, chals)] == jc
    assert np.array_equal(convert.to_numpy(tf), np.asarray(jf))
    assert tt.snapshot_state() == jt.snapshot_state()


def _plus_combs(scalar):
    jm, tm = get_ring("frog").fq, tget_ring("frog").fq
    if scalar:
        def jfn(v, c):
            return jmo.add(jm, jmo.mont_mul(jm, v[0], v[1]), v[2])

        def tfn(v, c):
            return tmo.add(tm, tmo.mont_mul(tm, v[0], v[1]), v[2])
    else:
        def jfn(v, c):
            return jmo.add(jm, jops.ext_mul(get_ring("frog"), v[0], v[1]), v[2])

        def tfn(v, c):
            return tmo.add(tm, tops.ext_mul(tget_ring("frog"), v[0], v[1]), v[2])
    return (jpsc.CombFn(get_ring("frog"), jfn, key=f"t:plus:{scalar}", scalar=scalar),
            tpsc.CombFn(tfn, scalar=scalar))


@pytest.mark.parametrize("scalar", [True, False], ids=["scalar", "ring"])
def test_plus_sumcheck_prove_device_matches_jax(scalar):
    ring, tring = get_ring("frog"), tget_ring("frog")
    nvars, degree = 4, 2
    rng = np.random.default_rng(5 + scalar)
    vdims = (ring.nl,) if scalar else (ring.ncomp, ring.e, ring.nl)
    ints = rng.integers(0, 2**62, size=(3, 1 << nvars) + vdims[:-1])
    tabs = ring.fq.encode(ints.astype(object))
    jcomb, tcomb = _plus_combs(scalar)

    jt, tt = PlusTranscript(ring), TPlusTranscript(tring)
    jt.absorb_tag(b"pdiff")
    tt.absorb_tag(b"pdiff")
    jp, jc, jf = jpsc.prove_host(ring, jt, jnp.asarray(tabs), nvars, degree, jcomb)
    tp, tc, tf = tpsc.prove_device(tring, tt, convert.tensor(tabs, CPU), nvars, degree, tcomb)
    assert tp.round_evals == jp.round_evals
    assert tc == jc
    assert np.array_equal(convert.to_numpy(tf), np.asarray(jf))
    assert tt.snapshot_state() == jt.snapshot_state()

    # on CPU tables ``prove`` takes the host prover: the same proof
    tt2 = TPlusTranscript(tring)
    tt2.absorb_tag(b"pdiff")
    hp, hc, _ = tpsc.prove(tring, tt2, convert.tensor(tabs, CPU), nvars, degree, tcomb)
    assert (hp.round_evals, hc) == (tp.round_evals, tc)
