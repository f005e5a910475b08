"""``python -m latticefold_torch.e2e`` on the CPU at a small witness length:
a two-step IVC chain that exits 0, prints the last proof's size (raw and
zlib) as ``serialization.serialize_proof`` gives it, verifies every step
and opens the folded commitment; ``run_chain`` returns each step's proof
and counters, and a chain proves the same bytes each time it is run; a
step folded with ``fused=True`` (``nifs.device_step.DeviceNIFS``, the
transcript on the device) proves the modular step's bytes.
Without a card and without ``--device cpu`` the entry point raises
(tests/test_torch_boundary.py). Tolerance: exact (bytes)."""

import re
import zlib

import pytest

from latticefold_torch import e2e
from latticefold_torch import serialization as ser

WIT_LEN = "4"


def test_main_two_steps_on_cpu(capsys, monkeypatch):
    runs = []
    fold_steps = e2e.fold_steps

    def keep(*args, **kw):
        runs.append(fold_steps(*args, **kw))
        return runs[-1]

    monkeypatch.setattr(e2e, "fold_steps", keep)
    assert e2e.main(["--device", "cpu", "--steps", "2", "--wit-len", WIT_LEN]) == 0
    out = capsys.readouterr().out
    (res,) = runs
    assert len(res.steps) == 2
    blob = ser.serialize_proof(res.setup.ring, res.steps[-1].proof)
    m = re.search(r"Proof size: (\d+) bytes \((\d+) bytes zlib-compressed\)", out)
    assert m and (int(m.group(1)), int(m.group(2))) == (len(blob), len(zlib.compress(blob)))
    assert "step 0: proof generated" in out and "step 1: proof generated" in out
    assert "all 2 step(s) verified" in out
    assert "folded witness opens folded commitment: True" in out
    assert "Decomposition parameters: B=32768 L=5 b=2 K=15" in out


def test_run_chain_records_each_step():
    res = e2e.run_chain("goldilocks", int(WIT_LEN), 1, 4, steps=2, device="cpu")
    s = res.setup
    assert (s.ccs.m, s.scheme.n, s.scheme.kappa) == (32, 4 * s.dp.L, 4)
    for st in res.steps:
        assert st.launches == {}  # no kernel runs on the CPU
        assert st.peak_bytes is None and st.live_bytes is None and st.prove_s > 0
    vacc = e2e.verify_chain(s, [st.proof for st in res.steps])
    assert ser.serialize_lcccs(s.ring, vacc) == ser.serialize_lcccs(s.ring, res.acc)
    assert res.w_acc.commit(s.scheme) == res.acc.cm
    # the same chain proves the same bytes; a step's bytes differ from the last
    again = e2e.fold_steps(s, 1)
    assert ser.serialize_proof(s.ring, again.steps[0].proof) == ser.serialize_proof(s.ring, res.steps[0].proof)
    assert ser.serialize_proof(s.ring, res.steps[0].proof) != ser.serialize_proof(s.ring, res.steps[1].proof)


def test_fused_flag_is_not_offered(capsys):
    """``--fused`` is not offered for a preset DeviceNIFS does not take
    (B >= 2^16: Stark's B is 10485760000): the command line refuses it,
    naming the reason, before any setup."""
    with pytest.raises(SystemExit):
        e2e.main(["--device", "cpu", "--fused", "--ring", "stark", "--wit-len", WIT_LEN])
    err = capsys.readouterr().err
    assert "--fused is not offered for stark" in err and "B < 2^16" in err


def test_run_chain_fused_matches_modular():
    """One step of the chain through DeviceNIFS gives the modular step's
    proof and accumulator bytes and transcript state; its proof verifies."""
    ring_name = "frog"
    fused = e2e.run_chain(ring_name, int(WIT_LEN), 1, 4, steps=1, device="cpu", fused=True)
    plain = e2e.run_chain(ring_name, int(WIT_LEN), 1, 4, steps=1, device="cpu")
    ring = fused.setup.ring
    assert fused.setup.fused is not None and plain.setup.fused is None
    assert ser.serialize_proof(ring, fused.steps[0].proof) == ser.serialize_proof(ring, plain.steps[0].proof)
    assert ser.serialize_lcccs(ring, fused.acc) == ser.serialize_lcccs(ring, plain.acc)
    assert fused.steps[0].transcript_state == plain.steps[0].transcript_state
    assert fused.steps[0].launches == {} and not fused.steps[0].big_m
    vacc = e2e.verify_chain(fused.setup, [fused.steps[0].proof])
    assert ser.serialize_lcccs(ring, vacc) == ser.serialize_lcccs(ring, fused.acc)
    assert fused.w_acc.commit(fused.setup.scheme) == fused.acc.cm
