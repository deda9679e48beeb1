"""The replay lock and each device's replay stream.

Captured replays (`exec/tpu_engine._CompiledPlan`) and the writes that
change what they read in place (the delta patches of `storage/deltas`, the
tier pool loads of `storage/tiering`) are ordered by the two objects here:
the lock keeps a write and a replay dispatch from interleaving on the host,
and the stream orders them on the card, so a write queued after a replay
runs after it and the next replay runs after the write.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Tuple

import torch

#: serialises replays: all plans of a device share one graph memory pool,
#: so one replay's intermediates may overwrite another's outputs; each
#: replay's outputs are copied out before the lock is released. Every
#: in-place write to what a captured replay reads is made under it too.
REPLAY_LOCK = threading.RLock()
#: device → (graph memory pool handle, replay stream)
_RESOURCES: Dict[torch.device, Tuple[object, "torch.cuda.Stream"]] = {}


def replay_resources(device: torch.device):
    """The device's (graph memory pool handle, replay stream), made on
    first use."""
    with REPLAY_LOCK:
        res = _RESOURCES.get(device)
        if res is None:
            with torch.cuda.device(device):
                res = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(device))
            _RESOURCES[device] = res
    return res


def on_replay_stream(device: torch.device):
    """Context running work on the device's replay stream (no-op on the
    CPU): what reads a replay's outputs queues behind it there."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(replay_resources(device)[1])
