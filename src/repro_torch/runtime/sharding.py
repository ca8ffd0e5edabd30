"""Single-device ``Sharder``: the model code's sharding hooks as identities.

The JAX ``Sharder`` resolves logical axes against a device mesh. The port
runs on one card until its distribution slice lands (ROADMAP M11), so every
hook returns its input and a mesh is refused rather than ignored.
"""

from __future__ import annotations

from typing import Any, Optional


class Sharder:
    def __init__(self, mesh: Any = None):
        if mesh is not None:
            raise NotImplementedError(
                "repro_torch runs on one device: meshes arrive with the "
                "distribution slice (ROADMAP M11)")
        self.mesh = None

    def constrain(self, x, *axes: Optional[str]):
        return x

    def sp_boundary(self, x):
        return x

    def gather(self, w, *axes: Optional[str]):
        return w

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "Sharder(mesh=None)"
