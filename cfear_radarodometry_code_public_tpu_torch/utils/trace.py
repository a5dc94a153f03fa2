"""The port's profiler spans and counters, free while no profiler records.

    with trace.span("register"):          # a `record_function` range
        ...
    if trace.item("sync.register", done.all()):   # a host sync, in a span
        ...
    trace.count("features.points", n)     # a host int or a 0-d tensor
    trace.counters()                      # {name: int}, one sync a device
    trace.reset_counters()

`span(name)` is `torch.profiler.record_function(name)` while a torch
profiler records, so the range lands in the same kineto timeline as the
device work launched under it; otherwise it is one shared no-op context.
A `record_function` costs about 10 us a use even when nothing records; the
check costs under a tenth of that.

`count(name, value)` adds to a named counter, again only while a profiler
records. A tensor value is kept on its device unsummed, so counting costs
no sync and no launch beyond the ones that made the value; `counters()`
sums them with one read-back a device. The counters are the process's, as
the kernels' `launches` counters are, and run on until `reset_counters()`.

Span names: the stages keep the reference's (`Filtering`, `compensate`,
`build_normals`, `register`, `associate`, `lm_solve`, `sample_covariance`,
`health_check`); `features.*` are the stages of `compute_cells_batched`;
`fleet.*` the fleet runner's upload and read-back; every host sync on the
main path sits in a `sync.*` span or in `fleet.readback`.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

_OFF = contextlib.nullcontext()
_host: dict = defaultdict(int)
_device: dict = defaultdict(list)


def recording() -> bool:
    """Whether a torch profiler records: a caller computes a counter's
    value only then."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A profiler range named `name` while a profiler records, else the
    shared no-op context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def item(name: str, value: torch.Tensor):
    """`value.item()`, the host's wait for the device, inside the span
    `name` (a `sync.*` name on the main path)."""
    with span(name):
        return value.item()


def count(name: str, value) -> None:
    """Add `value` (a Python int, or a 0-d tensor holding a whole number)
    to the counter `name` while a profiler records; nothing otherwise."""
    if not torch._C._autograd._profiler_enabled():
        return
    if torch.is_tensor(value):
        _device[name].append(value)
    else:
        _host[name] += int(value)


def counters() -> dict:
    """Every counter's value as a Python int (one read-back a device)."""
    out = dict(_host)
    by_device = defaultdict(list)
    for name, values in _device.items():
        if values:
            by_device[values[0].device].append(name)
    for names in by_device.values():
        sums = torch.stack([torch.stack(_device[n]).double().sum()
                            for n in names])
        for name, v in zip(names, sums.tolist()):
            out[name] = out.get(name, 0) + round(v)
    return out


def reset_counters() -> None:
    _host.clear()
    _device.clear()
