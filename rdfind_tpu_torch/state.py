"""State handed over from the JAX package, as the port's tensors.

The system runs no model, so its state is data: the id triples, or the outputs of
the candidate-preparation and membership stages.  Both packages exchange it as
numpy arrays; these functions turn it into tensors on a given device, so that the
port computes on exactly the state the reference computed on.
"""

from __future__ import annotations

import numpy as np
import torch

# Stage-state fields and the dtype each takes on the device.
STAGE_DTYPES = {
    "line_gid": torch.int32,
    "cap_id": torch.int32,
    "valid": torch.bool,
    "cap_code": torch.int32,
    "cap_v1": torch.int32,
    "cap_v2": torch.int32,
    "dep_count": torch.int32,
    "m": torch.int8,
}


def triples_to_device(triples, device) -> torch.Tensor:
    """(N, 3) id triples -> an int32 tensor on `device`."""
    arr = np.asarray(triples)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"expected (N, 3) triples, got shape {arr.shape}")
    return torch.as_tensor(arr.astype(np.int32)).to(device)


def stage_state_to_device(state: dict, device) -> dict:
    """Stage outputs as numpy arrays -> tensors on `device`.

    Keys are those of STAGE_DTYPES: the per-candidate ``line_gid``, ``cap_id``,
    ``valid``; the capture table ``cap_code``/``cap_v1``/``cap_v2``; the
    per-capture ``dep_count``; and the membership matrix ``m`` (any 0/1 array,
    e.g. the reference's bf16 one).  Values are checked to survive the cast.
    """
    out = {}
    for key, arr in state.items():
        if key not in STAGE_DTYPES:
            raise KeyError(f"unknown stage-state field {key!r}")
        a = np.asarray(arr)
        if key == "m":
            a = np.asarray(a, np.float32)
            if not np.isin(a, (0.0, 1.0)).all():
                raise ValueError("membership matrix must be 0/1")
            a = a.astype(np.int8)
        elif key == "valid":
            a = a.astype(bool)
        else:
            if a.size and (a.min() < np.iinfo(np.int32).min
                           or a.max() > np.iinfo(np.int32).max):
                raise ValueError(f"{key} does not fit int32")
            a = a.astype(np.int32)
        out[key] = torch.as_tensor(a).to(device=device,
                                         dtype=STAGE_DTYPES[key])
    return out
