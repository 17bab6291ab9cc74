"""Model server with in-place weight updates (counterpart of
``repro.serving.server.ModelServer``).

The rollout engine reads the live parameter dict and its version from
here; ``update_weights`` swaps in new parameters without any file
round trip.
"""

from __future__ import annotations

import time
from typing import Any


class ModelServer:
    """Keeps the live parameters and a monotonically increasing version."""

    def __init__(self, params: Any):
        self._params = params
        self.version = 0
        self.update_seconds = 0.0

    @property
    def params(self):
        return self._params

    def params_versioned(self) -> tuple[int, Any]:
        return self.version, self._params

    def update_weights(self, new_params) -> int:
        t0 = time.perf_counter()
        self._params = new_params
        self.update_seconds = time.perf_counter() - t0
        self.version += 1
        return self.version
