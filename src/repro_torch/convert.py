"""Hand one state between the two packages as numpy arrays.

``from_jax_state`` turns the reference's table and ``{"step", "m", "v"}``
optimizer state (as numpy arrays, e.g. ``jax.device_get`` of them) into
the port's tensors; ``to_numpy`` goes the other way.  Tests and the chip
smoke script start both packages from one state this way, since the
port's ``init_fn`` draws other numbers than ``jax.random.normal``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _tensor(a: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def from_jax_state(table_np: np.ndarray, opt_state_np: Dict, device="cuda"
                   ) -> Tuple[torch.Tensor, Dict]:
    """(table, opt_state) on ``device``; the step counter stays on the
    host as an int32 scalar, where the port keeps it."""
    state = {"step": torch.tensor(int(np.asarray(opt_state_np["step"])),
                                  dtype=torch.int32),
             "m": _tensor(opt_state_np.get("m"), device),
             "v": _tensor(opt_state_np["v"], device)}
    return _tensor(table_np, device), state


def to_numpy(table: torch.Tensor, opt_state: Dict
             ) -> Tuple[np.ndarray, Dict]:
    """The reverse of ``from_jax_state``: numpy copies in the reference's
    layout."""
    def arr(t):
        return None if t is None else t.detach().cpu().numpy()
    return arr(table), {"step": np.asarray(int(opt_state["step"]), np.int32),
                        "m": arr(opt_state["m"]), "v": arr(opt_state["v"])}
