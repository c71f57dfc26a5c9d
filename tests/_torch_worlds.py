"""Twin worlds for the port's parity tests: the same numpy data and seeds
built once as reference (``repro``) objects and once as port
(``repro_torch``) objects, so both packages see identical batches."""
import numpy as np

from repro.core.budget import WorkloadSpec as RefWorkloadSpec
from repro.data.pipeline import ClientDataset as RefClientDataset
from repro.fed.client import FLClient as RefFLClient
from repro.models.small import SmallModelConfig as RefSmallModelConfig
from repro_torch.core.budget import WorkloadSpec
from repro_torch.data.pipeline import ClientDataset
from repro_torch.fed.client import FLClient
from repro_torch.models.small import SmallModelConfig

#: the test-size FEMNIST-style MLP: 8x8 images, hidden 16, two layers
MCFG_KW = dict(kind="mlp", hidden=16, n_layers=2, image_size=8, channels=1,
               n_classes=10)
REF_MCFG = RefSmallModelConfig(**MCFG_KW)
MCFG = SmallModelConfig(**MCFG_KW)


def client_arrays(batch_sizes, seed=0, samples_per_client=16):
    """Per-client (x, y) numpy shards, made from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in batch_sizes:
        x = rng.normal(size=(samples_per_client, MCFG.image_size,
                             MCFG.image_size, MCFG.channels)).astype(np.float32)
        y = rng.integers(0, MCFG.n_classes, size=samples_per_client).astype(np.int32)
        out.append((x, y))
    return out


def twin_clients(batch_sizes, seed=0, budgets=None, samples_per_client=16,
                 n_batches=10):
    """(reference clients, port clients) over identical shards and seeds."""
    arrays = client_arrays(batch_sizes, seed, samples_per_client)
    budgets = budgets or [100.0] * len(batch_sizes)
    ref, port = [], []
    for i, ((x, y), bs, b) in enumerate(zip(arrays, batch_sizes, budgets)):
        wl = dict(model="mlp", n_layers=MCFG.n_layers, batch_size=bs,
                  n_batches=n_batches)
        ref.append(RefFLClient(i, b, RefClientDataset(x, y, bs, seed=seed + i),
                               RefWorkloadSpec(**wl)))
        port.append(FLClient(i, b, ClientDataset(x, y, bs, seed=seed + i),
                             WorkloadSpec(**wl)))
    return ref, port


def max_tree_diff(a, b):
    """Largest |a - b| over the leaves of two trees given as path dicts."""
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    return max(float(np.max(np.abs(np.asarray(a[k], np.float32)
                                    - np.asarray(b[k], np.float32)))) for k in a)
