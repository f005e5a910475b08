"""Guards on the port's boundary: nothing in ``latticefold_torch/`` or in
``chip_smoke.py`` imports JAX or the JAX package, and the entry points refuse
to run without a card unless the caller asks for the CPU."""

import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "latticefold_tpu")


def _port_files():
    out = []
    for base, _, files in os.walk(os.path.join(ROOT, "latticefold_torch")):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    out.append(os.path.join(ROOT, "chip_smoke.py"))
    return sorted(os.path.relpath(p, ROOT) for p in out)


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_imports(path):
    with open(os.path.join(ROOT, path)) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from latticefold_torch import convert
    from latticefold_torch.commitment import AjtaiScheme
    from latticefold_torch.poly import mle
    from latticefold_torch.rings import ops
    from latticefold_torch.rings.construct import get_ring

    ring = get_ring("goldilocks")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AjtaiScheme(ring, 2, 8, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.to_device(ring, [ring.one()])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mle.point_to_device(ring, [ring.K.one()])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.tensor(np.zeros((2, ring.nl), dtype=np.uint32))
    # and the same calls run when the CPU is asked for
    assert AjtaiScheme(ring, 2, 8, seed=1, device="cpu").matrix.device.type == "cpu"


def test_chain_entry_points_refuse_without_a_card():
    """``python -m latticefold_torch.e2e`` runs on the card unless
    ``--device cpu`` is given, and a checkpointed witness is read onto the
    card unless the caller names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from latticefold_torch import e2e, serialization
    from latticefold_torch.rings.construct import get_ring

    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2e.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2e.run_chain(wit_len=2)
    ring = get_ring("goldilocks")
    blob = serialization.serialize_witness_f(ring, torch.zeros((1, ring.d, ring.nl), dtype=torch.int64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serialization.deserialize_witness_f(ring, blob)
    assert serialization.deserialize_witness_f(ring, blob, "cpu").device.type == "cpu"


def test_plus_entry_points_refuse_without_a_card():
    """LatticeFold+ (``latticefold_torch/plus/``, covered by
    test_no_jax_imports) makes its tables on the card unless the caller
    names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from latticefold_torch.plus import mleops, setchk
    from latticefold_torch.plus.transcript import PlusTranscript
    from latticefold_torch.rings.construct import get_ring

    assert any(p.startswith(os.path.join("latticefold_torch", "plus")) for p in _port_files())
    ring = get_ring("frog")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mleops.scalars_dev(ring, [1, 2])
    sets = [setchk.MatrixSet(idx=np.zeros((4, 4), dtype=np.int64))]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setchk.set_check(ring, 2, sets, [], PlusTranscript(ring))
    assert mleops.scalars_dev(ring, [1, 2], "cpu").device.type == "cpu"
