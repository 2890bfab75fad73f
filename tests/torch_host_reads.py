"""The host-read lint of the port's graphed functions, shared by the test files.

A CUDA graph's capture refuses an operation that reads a tensor's values back on the
host (item, tolist, numpy, cpu, a data-dependent shape) and one that builds a tensor on
the device from host data.  :func:`assert_reads_nothing_back` shows on the CPU that a
call makes neither, so that its capture on the card cannot fail for it.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from m3t_tpu_torch import graphs
from m3t_tpu_torch.ops import depth_fast, occlusion, region_fast


class HostReads(TorchDispatchMode):
    """The aten operations that read a tensor's values back on the host, or give a
    shape that depends on them (both a capture forbids), by name; none while
    ``paused`` (the kernels' plain twins, which stand in for the kernels on the CPU).
    ``_linalg_check_errors`` is torch.linalg's check of a factorization's info, which
    reads it on the host (on the CPU without a ``_local_scalar_dense``)."""

    DATA_DEPENDENT = ("nonzero", "masked_select", "unique", "_unique", "_unique2",
                      "unique_consecutive", "unique_dim", "_local_scalar_dense",
                      "repeat_interleave", "_linalg_check_errors")

    def __init__(self):
        super().__init__()
        self.found, self.paused = [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        boolean_index = name in ("index", "index_put", "index_put_") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in (args[1] if len(args) > 1 else ()) or ())
        if not self.paused and (name in self.DATA_DEPENDENT or boolean_index):
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


def assert_reads_nothing_back(fn, args, kwargs, monkeypatch):
    """fn(*args, **kwargs), run eagerly on CPU tensors, reads no value back on the host
    and builds no tensor on a device from host data (``torch.as_tensor`` or
    ``torch.tensor`` with a device and data that is not a tensor); the kernels' plain
    twins, which run on the CPU only, are left out.  Returns fn's result."""
    reads, made = HostReads(), []

    def refuse(what, real):
        def method(*a, **k):
            if not reads.paused:
                raise AssertionError(f"the function calls Tensor.{what}")
            return real(*a, **k)
        return method

    for what in ("tolist", "numpy", "cpu", "item", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, what, refuse(what, getattr(torch.Tensor, what)))
    for factory in ("as_tensor", "tensor"):
        def recorded(data, *a, real=getattr(torch, factory), factory=factory, **k):
            if (not reads.paused and k.get("device") is not None
                    and not isinstance(data, torch.Tensor)):
                made.append(factory)
            return real(data, *a, **k)
        monkeypatch.setattr(torch, factory, recorded)
    for module, kernel in ((region_fast, "sample_lines"), (region_fast, "bin_counts"),
                           (depth_fast, "sample_windows"), (occlusion, "query_eval")):
        def twin(*a, real=getattr(module, kernel), **k):
            reads.paused = True
            try:
                return real(*a, **k)
            finally:
                reads.paused = False
        monkeypatch.setattr(module, kernel, twin)
    try:
        with reads, graphs.disable_graphs():
            out = fn(*args, **kwargs)
    finally:
        monkeypatch.undo()
    assert reads.found == [] and made == [], (reads.found, made)
    return out
