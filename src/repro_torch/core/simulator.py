"""Round-result types of the discrete-event engine.

The reference keeps ``RoundSimulator`` here, a one-round facade over the
campaign engine; the port's trainer needs only the result types, which
live in ``repro_torch.core.campaign`` and are re-exported here so the
module layout matches the reference.
"""
from repro_torch.core.campaign import RoundResult, SimClient  # noqa: F401
