"""FedScale-style closed-form latency estimator — the paper's foil.

FedScale estimates client time as ``data_volume × per-sample latency ÷
device speed``: it responds to the amount of data and the device-speed
trace, but is blind to model depth, sequence length and batch size (its
per-sample constant is fixed per model *name*).  Fig 7 shows exactly this:
S1 (hardware constraint) moves the estimate, S2–S4 (batch/layers/seq-len)
do not.  We implement it faithfully so benchmarks can contrast it with
FedHC's framework-provided runtime.  A copy of ``repro.core.estimator``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.budget import WorkloadSpec


@dataclass
class FedScaleEstimator:
    # fixed per-model per-sample latency (seconds) — calibrated once,
    # never re-measured when the workload's shape changes
    per_sample_latency: Dict[str, float] = None

    def __post_init__(self):
        if self.per_sample_latency is None:
            self.per_sample_latency = {"lstm": 2e-3, "cnn": 1e-3, "resnet": 4e-3, "mlp": 2e-4}

    def seconds(self, workload: WorkloadSpec, speed_factor: float = 1.0) -> float:
        """speed_factor plays the role of FedScale's device-speed entry
        (budget/100 in our budget vocabulary)."""
        n_samples = workload.n_batches * workload.batch_size
        lat = self.per_sample_latency.get(workload.model, 1e-3)
        # NOTE: deliberately ignores n_layers / seq_len / batch efficiency /
        # extra_local_model — that blindness is the point.
        return n_samples * lat / max(speed_factor, 1e-6)
