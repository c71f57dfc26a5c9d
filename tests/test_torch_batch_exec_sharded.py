"""The port's dense client wave sharded over a mesh, across ranks.

The reference's ``test_dense_wave_shard_map_matches_unsharded_subprocess``
on 4 gloo ranks: ``BatchedExecutor(mesh=, rules=)`` splits the dense
wave's client axis over the mesh (6 clients pad to 8 on 4 ranks), every
rank trains its slice and returns the whole wave.  Each world runs in a
subprocess of its own (``tests/_torch_wave_ranks.py``) under a timeout:
the reference's sharded waves on 4 forced JAX host devices, then the
port's on 4 gloo ranks; the port's unsharded waves run here.

* the stacked MLP (``torch.bmm``): every rank's deltas and metrics equal
  the unsharded wave's exactly (the reference asserts 0.0), and the
  reference's sharded wave within ``test_torch_batch_exec.py``'s 1e-5;
* a vmapped model (the CNN): the metrics equal exactly; the deltas within
  1e-6, not exactly, since a convolution vmapped over 2 clients is not
  summed as over 6 or 5 (read: 2.98e-08);
* a rules override (clients over "model" of a 2 × 2 mesh) and the default
  rules on it (clients over "data");
* ragged and single-client waves ignore the mesh: the unsharded result on
  every rank, with the same ``stats`` and ``last_wave``;
* ``_wave_partition`` against the reference's on FakeMeshes (a rules
  override, an absent axis, a size-1 axis), and a mesh of another device
  type than the executor's refused.
"""
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

from repro.fed.batch_exec import BatchedExecutor as RefBatchedExecutor
from repro.optim.optimizers import make_optimizer as ref_make_optimizer
from repro_torch.fed.batch_exec import BatchedExecutor
from repro_torch.optim.optimizers import make_optimizer

from _torch_worlds import MCFG, REF_MCFG

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANKS = ROOT / "tests" / "_torch_wave_ranks.py"
sys.path.insert(0, str(ROOT / "tests"))
import _torch_wave_ranks as W  # noqa: E402

TIMEOUT = 300
REF_TOL = 1e-5          # tests/test_torch_batch_exec.py's bound against the reference
VMAP_TOL = 1e-6         # a vmapped wave sharded against unsharded


def _run(mode, directory):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, str(RANKS), mode, str(directory)], env=env,
                         cwd=str(ROOT), capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, (mode, out.stdout[-3000:], out.stderr[-3000:])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's sharded waves, the 4-rank gloo world's, and the
    port's unsharded waves, once a module."""
    d = tmp_path_factory.mktemp("wave")
    _run("ref", d)
    _run("port", d)
    with open(d / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    ranks = []
    for r in range(W.WORLD):
        with open(d / f"port{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    plain = {w[0]: W.port_wave(w, ref[w[0]]["params"]) for w in W.WAVES}
    return ref, ranks, plain


def _max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x[0][k], np.float32)
                                   - np.asarray(y[0][k], np.float32))))
               for x, y in zip(a, b) for k in x[0])


@pytest.mark.parametrize("wave", W.WAVES, ids=[w[0] for w in W.WAVES])
def test_every_rank_returns_the_whole_wave(worlds, wave):
    name, mcfg_kw, sizes = wave[:3]
    ref, ranks, plain = worlds
    want, want_stats, want_last = plain[name]
    mode = want_last["mode"]
    assert mode == ref[name]["mode"] == {"mlp ragged": "ragged", "mlp seq": "seq"}.get(
        name, "dense")
    exact = mcfg_kw["kind"] == "mlp"
    for r, got in enumerate(ranks):
        res, stats, last = got[name]
        assert len(res) == len(sizes)          # the filler dropped
        assert last == want_last and stats == want_stats, (r, last, stats)
        for (gd, gn, gm), (wd, wn, wm) in zip(res, want):
            assert gn == wn and gm == wm and sorted(gd) == sorted(wd)
        diff = _max_diff(res, want)
        assert diff == 0.0 if exact else diff < VMAP_TOL, (r, diff)
        assert _max_diff(res, ref[name]["results"]) < REF_TOL, r
        for (_, gn, gm), (_, rn, rm) in zip(res, ref[name]["results"]):
            assert gn == rn
            for k in rm:
                assert gm[k] == pytest.approx(rm[k], abs=REF_TOL), k


def test_six_clients_pad_to_eight_and_match_the_reference_sharded_wave(worlds):
    """The reference's own case: the sharded MLP wave equals the unsharded
    one bit for bit on every rank."""
    ref, ranks, plain = worlds
    name = W.WAVES[0][0]
    assert len(W.WAVES[0][2]) % W.WORLD == 2          # 6 clients: 2 of filler
    for got in ranks:
        assert _max_diff(got[name][0], plain[name][0]) == 0.0
    assert _max_diff(ranks[0][name][0], ref[name]["results"]) < REF_TOL


class FakeMesh:
    """Just enough mesh for either package's ``_wave_partition``."""

    def __init__(self, shape, names, device_type="cpu"):
        self.axis_names = names
        self.devices = np.empty(shape)
        self.shape = dict(zip(names, shape))
        self.device_type = device_type


PARTITIONS = [
    ((4,), ("data",), None),
    ((2, 2), ("data", "model"), None),
    ((2, 2), ("data", "model"), {"clients": "model"}),
    ((2, 2, 2), ("pod", "data", "model"), None),
    ((1, 4), ("data", "model"), None),                  # a size-1 batch axis
    ((4,), ("model",), None),                           # no batch axis at all
    ((2, 4), ("pod", "model"), {"clients": ("data", "model")}),   # an absent axis
    ((4,), ("data",), {"clients": None}),
]


@pytest.mark.parametrize("shape,names,rules", PARTITIONS,
                         ids=[f"{'x'.join(map(str, s))}-{'-'.join(n)}-{r}"
                              for s, n, r in PARTITIONS])
def test_wave_partition_matches_the_reference(shape, names, rules):
    mesh = FakeMesh(shape, names)
    want = RefBatchedExecutor(REF_MCFG, ref_make_optimizer("sgd", 0.1), mesh=mesh,
                              rules=rules)._wave_partition()
    got = BatchedExecutor(MCFG, make_optimizer("sgd", 0.1), device="cpu", mesh=mesh,
                          rules=rules)._wave_partition()
    assert got == want


def test_a_mesh_of_another_device_type_is_refused():
    with pytest.raises(ValueError, match="cuda mesh"):
        BatchedExecutor(MCFG, make_optimizer("sgd", 0.1), device="cpu",
                        mesh=FakeMesh((4,), ("data",), device_type="cuda"))
