"""The counter primitive of the observability plane.

Only ``Counter`` is ported so far: the trainer and the campaign engine use
it for their byte and event accounting when no observability plane is
attached.  The registry, tracer and exporters are still to port.
"""
from __future__ import annotations


class Counter:
    """Monotonic accumulator (int or float, matching what you feed it)."""

    __slots__ = ("value",)

    def __init__(self, value=0):
        self.value = value

    def inc(self, n=1):
        self.value += n

    def reset(self, value=0) -> None:
        """Checkpoint-resume support: restore an absolute value."""
        self.value = value

    def __int__(self) -> int:
        return int(self.value)

    def __float__(self) -> float:
        return float(self.value)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Counter({self.value!r})"
