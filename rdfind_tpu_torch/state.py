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
    # Packed Bloom words (uint32 bit patterns, held as int32) and popcounts.
    "sketches": torch.int32,
    "ref_packed": torch.int32,
    "ref_popc": torch.int32,
}
PACKED_FIELDS = ("sketches", "ref_packed")

# The host dict of phase A (models/allatonce.prepare_join_lines): int64 arrays
# of the (value, capture)-sorted frequent join-line rows and of the capture
# table, plus the scalar num_caps.
HOST_FIELDS = ("line_val_h", "line_cap_h", "cap_code", "cap_v1", "cap_v2",
               "dep_count")


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
    per-capture ``dep_count``; the membership matrix ``m`` (any 0/1 array,
    e.g. the reference's bf16 one); the packed Bloom words ``sketches`` and
    ``ref_packed`` (uint32 words reinterpreted bit for bit as int32) and the
    ``ref_popc`` popcounts.  Values are checked to survive the cast.
    """
    out = {}
    for key, arr in state.items():
        if key not in STAGE_DTYPES:
            raise KeyError(f"unknown stage-state field {key!r}")
        a = np.array(arr)  # a writable copy, whatever the source
        if key == "m":
            a = np.asarray(a, np.float32)
            if not np.isin(a, (0.0, 1.0)).all():
                raise ValueError("membership matrix must be 0/1")
            a = a.astype(np.int8)
        elif key == "valid":
            a = a.astype(bool)
        elif key in PACKED_FIELDS and a.dtype == np.uint32:
            a = np.ascontiguousarray(a).view(np.int32)
        else:
            if a.size and (a.min() < np.iinfo(np.int32).min
                           or a.max() > np.iinfo(np.int32).max):
                raise ValueError(f"{key} does not fit int32")
            a = a.astype(np.int32)
        out[key] = torch.as_tensor(a).to(device=device,
                                         dtype=STAGE_DTYPES[key])
    return out


def phase_a_state(state: dict) -> dict:
    """The JAX package's phase-A dict (its prepare_join_lines) as the port's:
    the HOST_FIELDS as int64 numpy arrays and ``num_caps``; other keys are
    dropped."""
    out = {key: np.asarray(state[key]).astype(np.int64) for key in HOST_FIELDS}
    out["num_caps"] = int(state["num_caps"])
    return out
