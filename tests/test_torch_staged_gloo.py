"""The ``staged_gloo`` process-group backend (``repro_torch.dist``), which
the card's world of several ranks on one device runs on, and the name
``launch.mesh.world_backend`` picks for each world.

The backend is exercised on 2 CPU ranks in a subprocess
(``tests/_torch_staged_ranks.py``): every collective it implements,
directly, as DTensor's functional collectives issue them, and through
DTensor's Shard → Replicate and Partial → Replicate moves; each result is
the collective's, and the bytes each rank staged are counted by
collective (a reduce-scatter staged as an all-reduce of its whole input).
"""
import os
import pathlib
import pickle
import subprocess
import sys

import pytest

from repro_torch.launch.mesh import world_backend

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANKS = ROOT / "tests" / "_torch_staged_ranks.py"
TIMEOUT = 180


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("staged")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(RANKS), str(d)], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    got = []
    for r in range(2):
        with open(d / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got


def test_world_backend_is_chosen_by_name():
    assert world_backend("cpu", 4) == "gloo"
    assert world_backend("cuda", 1) == "nccl"
    assert world_backend("cuda", 4, ranks_per_device=1) == "nccl"
    assert world_backend("cuda", 4, ranks_per_device=4) == "staged_gloo"
    with pytest.raises(ValueError):
        world_backend("xpu", 2)


@pytest.mark.parametrize("what, want", [
    ("all_reduce", [[10.0, 12.0, 14.0, 16.0]] * 2),
    ("functional all_gather", [[0.0, 1.0, 2.0, 3.0, 10.0, 11.0, 12.0, 13.0]] * 2),
    ("functional reduce_scatter", [[10.0, 12.0], [14.0, 16.0]]),
    ("all_to_all", [[0.0, 1.0, 10.0, 11.0], [2.0, 3.0, 12.0, 13.0]]),
    ("broadcast", [[10.0, 11.0, 12.0, 13.0]] * 2),
    ("shard to replicate", [[0.0, 1.0, 2.0, 3.0, 10.0, 11.0, 12.0, 13.0]] * 2),
    ("partial to replicate", [[10.0, 12.0, 14.0, 16.0]] * 2),
])
def test_every_collective_gives_its_result(ranks, what, want):
    assert [r[what] for r in ranks] == want
    assert all(r["backend"] == "staged_gloo" for r in ranks)


def test_the_staged_bytes_are_counted_by_collective(ranks):
    """Input bytes a rank: 16 (4 f32) for each direct call and move; the
    reduce-scatter's whole 16-byte input, staged as an all-reduce."""
    for r in ranks:
        staged = r["staged"]
        assert staged["all_reduce"] == 2 * 16          # direct, and the Partial move
        assert staged["all_gather"] == 2 * 16          # functional, and the Shard move
        assert staged["reduce_scatter as all_reduce"] == 16
        assert staged["all_to_all"] == 16
        assert staged["broadcast"] == 16
