"""Worlds for ``tests/test_torch_batch_exec_sharded.py``, each run in a
subprocess of its own so that no process group (and no forced JAX device
count) ever lives in the pytest process:

    python tests/_torch_wave_ranks.py ref  DIR   # JAX, 4 forced host devices
    python tests/_torch_wave_ranks.py port DIR   # torch, 4 gloo ranks

``ref`` runs the reference's ``BatchedExecutor`` with a ``("data",)`` mesh
of the 4 devices on each wave of ``WAVES`` and pickles the params it drew
and every client's delta and metrics.  ``port`` runs the port's executor
on 4 gloo ranks over the same data and params, on the mesh (and rules)
each wave names, and pickles every rank's results, ``stats`` and
``last_wave``.  Only ``ref`` imports JAX; the port's clients are built
here from the same numpy arrays as ``tests/_torch_worlds.py`` builds them.
Every world ends with a ``barrier()`` before its process group is
destroyed.
"""
import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

WORLD = 4
#: the test-size client models (tests/_torch_worlds.py: MCFG_KW, KIND_KW)
MLP = dict(kind="mlp", hidden=16, n_layers=2, image_size=8, channels=1, n_classes=10)
CNN = dict(kind="cnn", hidden=16, n_layers=2, image_size=8, channels=3, n_classes=10)
#: (name, model, batch sizes, seed, steps, (optimizer, lr), mesh shape and
#: axes, rules): the reference's own sharded case (6 MLP clients pad to 8),
#: the same for a vmapped model (the CNN), the client axis over "model" of a
#: 2 x 2 mesh by a rules override and over "data" by default, and a ragged
#: and a single-client (seq) wave, which ignore the mesh
WAVES = (
    ("mlp 6 clients", MLP, [4] * 6, 11, 3, ("sgd", 0.1), ((4,), ("data",)), None),
    ("cnn 6 clients", CNN, [4] * 6, 6, 2, ("sgd", 0.05), ((4,), ("data",)), None),
    ("mlp 5 clients, clients over model", MLP, [4] * 5, 3, 2, ("sgd", 0.1),
     ((2, 2), ("data", "model")), {"clients": "model"}),
    ("cnn 5 clients, 2 x 2 default rules", CNN, [4] * 5, 4, 2, ("momentum", 0.05),
     ((2, 2), ("data", "model")), None),
    ("mlp ragged", MLP, [2, 4, 6, 8], 7, 2, ("sgd", 0.1), ((4,), ("data",)), None),
    ("mlp seq", MLP, [4], 3, 3, ("sgd", 0.1), ((4,), ("data",)), None),
)
SAMPLES = 16


def arrays(mcfg_kw, batch_sizes, seed):
    """Per-client (x, y) numpy shards: ``_torch_worlds.client_arrays``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in batch_sizes:
        x = rng.normal(size=(SAMPLES, mcfg_kw["image_size"], mcfg_kw["image_size"],
                             mcfg_kw["channels"])).astype(np.float32)
        y = rng.integers(0, mcfg_kw["n_classes"], size=SAMPLES).astype(np.int32)
        out.append((x, y))
    return out


def port_clients(mcfg_kw, batch_sizes, seed):
    """The port's half of ``_torch_worlds.twin_clients``."""
    from repro_torch.core.budget import WorkloadSpec
    from repro_torch.data.pipeline import ClientDataset
    from repro_torch.fed.client import FLClient

    out = []
    for i, ((x, y), bs) in enumerate(zip(arrays(mcfg_kw, batch_sizes, seed), batch_sizes)):
        wl = dict(model=mcfg_kw["kind"], n_layers=mcfg_kw["n_layers"], batch_size=bs,
                  n_batches=10, extra_local_model=False)
        out.append(FLClient(i, 100.0, ClientDataset(x, y, bs, seed=seed + i), WorkloadSpec(**wl)))
    return out


def port_wave(wave, host_params, mesh=None, rules=None):
    """(results as numpy, stats, last_wave) of the port's executor on ``wave``."""
    from repro_torch.bridge import flatten, params_from_numpy
    from repro_torch.fed.batch_exec import BatchedExecutor
    from repro_torch.models.small import SmallModelConfig
    from repro_torch.optim.optimizers import make_optimizer

    name, mcfg_kw, sizes, seed, steps, (opt, lr), _, _ = wave
    ex = BatchedExecutor(SmallModelConfig(**mcfg_kw), make_optimizer(opt, lr), device="cpu",
                         mesh=mesh, rules=rules)
    res = ex.run_wave(params_from_numpy(host_params, "cpu"), port_clients(mcfg_kw, sizes, seed),
                      steps, round_idx=1)
    return ([(flatten(d), n, m) for d, n, m in res], ex.stats.as_dict(), dict(ex.last_wave))


def run_ref(out_dir):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.ckpt.checkpoint import _flatten
    from repro.core.budget import WorkloadSpec
    from repro.data.pipeline import ClientDataset
    from repro.fed.batch_exec import BatchedExecutor
    from repro.fed.client import FLClient
    from repro.models.small import SmallModelConfig, init_small
    from repro.optim.optimizers import make_optimizer

    assert len(jax.devices()) == WORLD, jax.devices()
    mesh = Mesh(np.array(jax.devices()), ("data",))
    out = {}
    for name, mcfg_kw, sizes, seed, steps, (opt, lr), _, _ in WAVES:
        mcfg = SmallModelConfig(**mcfg_kw)
        params = jax.tree.map(np.asarray, jax.device_get(init_small(jax.random.PRNGKey(seed),
                                                                    mcfg)))
        clients = []
        for i, ((x, y), bs) in enumerate(zip(arrays(mcfg_kw, sizes, seed), sizes)):
            wl = dict(model=mcfg.kind, n_layers=mcfg.n_layers, batch_size=bs, n_batches=10,
                      extra_local_model=False)
            clients.append(FLClient(i, 100.0, ClientDataset(x, y, bs, seed=seed + i),
                                    WorkloadSpec(**wl)))
        ex = BatchedExecutor(mcfg, make_optimizer(opt, lr), mesh=mesh)
        res = ex.run_wave(params, clients, steps, round_idx=1)
        out[name] = {"params": params, "mode": ex.last_wave["mode"],
                     "results": [({k: np.asarray(v) for k, v in _flatten(jax.device_get(d)).items()},
                                  float(n), {k: float(v) for k, v in m.items()})
                                 for d, n, m in res]}
    with open(os.path.join(out_dir, "ref.pkl"), "wb") as f:
        pickle.dump(out, f)


def port_rank(rank, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method="file://" + os.path.join(out_dir, "rendezvous"),
                            rank=rank, world_size=WORLD)
    with open(os.path.join(out_dir, "ref.pkl"), "rb") as f:
        ref = pickle.load(f)
    meshes, out = {}, {}
    for wave in WAVES:
        name, (shape, axes), rules = wave[0], wave[6], wave[7]
        mesh = meshes.get(axes)
        if mesh is None:
            mesh = meshes[axes] = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        out[name] = port_wave(wave, ref[name]["params"], mesh, rules)
    with open(os.path.join(out_dir, f"port{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def run_port(out_dir):
    import torch.multiprocessing as mp

    mp.spawn(port_rank, args=(out_dir,), nprocs=WORLD, join=True)


if __name__ == "__main__":
    mode, directory = sys.argv[1], sys.argv[2]
    {"ref": run_ref, "port": run_port}[mode](directory)
