"""Launch counts of the port's hand-written kernels, CUDA graphs included.

Each kernel wrapper registers itself (`register`) and calls `count_launch`
where it launches its kernel. Outside a CUDA graph capture that adds one to
the wrapper's `launches`. During a capture the kernel does not run at the
call but at every replay of the graph, so the call adds one to the
wrapper's `captured` instead. Whoever captures and replays a graph
(solver/pcg.CapturedBody) takes `captured()` before and after its capture,
and at each replay adds the difference to the launches with
`count_replay(recorded)`. A counter therefore reads the device launches
whichever way they were issued.
"""

import torch

__all__ = ["register", "count_launch", "captured", "count_replay"]

_KERNELS = []


def register(wrapper):
    """Give a kernel wrapper its `launches` and `captured` counts (both 0)."""
    wrapper.launches = 0
    wrapper.captured = 0
    _KERNELS.append(wrapper)
    return wrapper


def count_launch(wrapper):
    """Count one launch of `wrapper`'s kernel on the current stream."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1  # launched by each replay of the graph
    else:
        wrapper.launches += 1


def captured():
    """Every registered wrapper's captured count, in registration order."""
    return tuple(w.captured for w in _KERNELS)


def count_replay(recorded):
    """Count the launches of one replay of a graph whose capture moved
    `captured()` by `recorded` (a tuple of the same length)."""
    for w, n in zip(_KERNELS, recorded):
        w.launches += n
