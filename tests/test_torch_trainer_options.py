"""The port's trainer against the reference's with its other options:
uplink compression (none/topk/int8, with the reference's int8 noise
injected) under fedavg and async with failures, a deadline and
over-selection; the cnn, lstm and resnet clients; checkpoints and
``maybe_restore`` (a resumed run against an uninterrupted one and against
the reference's resumed run, and a resume from a reference checkpoint).
History fields of the engine are EQUAL, params within the wave's 1e-5
(1e-4 for the other client models, the reference's grads tolerance)."""
import jax
import numpy as np
import pytest

from repro.ckpt.checkpoint import _flatten as ref_flatten
from repro_torch.bridge import flatten

from _torch_worlds import (
    BATCH_SIZES, BUDGETS, assert_histories_match, kind_cfgs, max_tree_diff, twin_clients,
    twin_trainers)

COMPRESSED = [(agg, method) for agg in ("fedavg", "async") for method in ("none", "topk", "int8")]


@pytest.mark.parametrize("aggregation,compression", COMPRESSED,
                         ids=[f"{a}-{m}" for a, m in COMPRESSED])
def test_compressed_rounds_with_faults_match_reference(aggregation, compression):
    """Uplink compression under failures, a deadline and over-selection:
    the port compresses each delta with the reference's seed
    (``round * 1000 + cid``) and, for int8, the reference's noise, so the
    wire bytes are equal and the params agree to the wave's 1e-5."""
    ref, port = twin_trainers(aggregation=aggregation, compression=compression,
                               async_buffer=3, over_select_frac=0.5, failure_rate=0.3,
                               deadline_frac=0.9)
    ref_hist, port_hist = ref.run(), port.run()
    assert_histories_match(ref_hist, port_hist)
    assert port.comm_bytes == ref.comm_bytes > 0
    assert max_tree_diff(flatten(port.params),
                         ref_flatten(jax.device_get(ref.params))) < 1e-5


#: (kind, optimizer, compression).  The largest |Δparams| measured after 3
#: rounds on the CPU: cnn 1.49e-8, lstm 1.86e-9, resnet 2.97e-6.
#: The resnet runs uncompressed: with int8 it reads 1.75e-4, one stochastic
#: rounding step of a delta element whose two values differ by ~1e-7 and
#: straddle a draw.  The limit is the reference's grads tolerance.
CLIENT_KINDS = [("cnn", "momentum", "int8"), ("lstm", "sgd", "int8"),
                ("resnet", "adafactor", "none")]


@pytest.mark.parametrize("kind,optimizer,compression", CLIENT_KINDS,
                         ids=[k for k, _, _ in CLIENT_KINDS])
def test_client_kind_trainers_match_reference(kind, optimizer, compression):
    """Three rounds of dense (vmapped) waves of each of the paper's other
    client models against the reference trainer."""
    ref_mcfg, mcfg = kind_cfgs(kind)
    ref, port = twin_trainers(ref_mcfg, mcfg, batch_sizes=[4] * 6, optimizer=optimizer,
                               learning_rate=0.05, compression=compression)
    ref_hist, port_hist = ref.run(), port.run()
    assert_histories_match(ref_hist, port_hist, tol=1e-4)
    assert port.batch_exec.stats.dense_clients == port.batch_exec.stats.clients > 0
    assert max_tree_diff(flatten(port.params),
                         ref_flatten(jax.device_get(ref.params))) < 1e-4


def test_resumed_run_equals_an_uninterrupted_one_and_the_reference_s(tmp_path):
    """Two rounds checkpointed every round, then new trainers over the same
    clients restore them (``run`` calls ``maybe_restore``) and run round 3.
    Every client takes part in every round and none fails: the sampling RNG
    is not in the checkpoint (nor in the reference's), so only then is the
    resumed round the uninterrupted one."""
    kw = dict(participants_per_round=len(BATCH_SIZES), compression="int8")
    ref_full, full = twin_trainers(**kw)
    ref_full.run(3)
    full.run(3)

    clients = twin_clients(BATCH_SIZES, seed=4, budgets=BUDGETS)
    dirs = ({"ckpt_dir": str(tmp_path / "ref"), "ckpt_every": 1},
            {"ckpt_dir": str(tmp_path / "port"), "ckpt_every": 1})
    ref, port = twin_trainers(ref_kw=dirs[0], port_kw=dirs[1], clients=clients, **kw)
    ref.run(2)
    port.run(2)
    ref, port = twin_trainers(ref_kw=dirs[0], port_kw=dirs[1], clients=clients, **kw)
    with np.load(str(tmp_path / "port" / "ckpt_0000000002.npz")) as data:
        saved = {k: data[k] for k in data.files}
    assert port.maybe_restore() and port.round == 2
    assert all(np.array_equal(v, saved[k]) for k, v in flatten(port.params).items())
    port.run(1)
    ref.run(1)
    assert (port.round, port.sim_clock, port.comm_bytes) == (full.round, full.sim_clock,
                                                            full.comm_bytes)
    assert port.history == full.history
    assert max_tree_diff(flatten(port.params), flatten(full.params)) == 0.0
    assert_histories_match(ref.history, port.history)
    assert max_tree_diff(flatten(port.params), ref_flatten(jax.device_get(ref.params))) < 1e-5


def test_resume_from_a_reference_checkpoint(tmp_path):
    """The port's trainer resumes from the reference trainer's checkpoint
    directory: params bit for bit, and its clock, bytes and history."""
    ref, _ = twin_trainers(ref_kw={"ckpt_dir": str(tmp_path), "ckpt_every": 2})
    ref.run(2)
    _, port = twin_trainers(port_kw={"ckpt_dir": str(tmp_path)})
    assert port.maybe_restore()
    assert port.round == 2 and port.sim_clock == ref.sim_clock
    assert port.comm_bytes == ref.comm_bytes and port.history == ref.history
    assert max_tree_diff(flatten(port.params), ref_flatten(jax.device_get(ref.params))) == 0.0
