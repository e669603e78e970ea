"""One stand-in for the port's CUDA kernels in the CPU tests.

A CPU build of torch cannot launch a kernel.  Every binding module reaches
its kernel through ``ergo_uvo_tpu_torch.cuda_build`` (``bind`` for the
library, ``on_card`` for the card and its stream, ``launched`` for the
error and the count), so faking ``bind`` and ``on_card`` there stands in
for all of them: the wrappers' checks, their arguments, their order of
calls and their counters then run as they would on the card.

Not a test module (no ``test_`` prefix); the kernel test files import it.
It imports no JAX, so that those files also run on the machine with the card.
"""

import contextlib

from ergo_uvo_tpu_torch import cuda_build


class FakeLibrary:
    """Stands in for a built library: records each entry point's call and
    returns ``err``.  ``current`` is the device the fake ``on_card`` made
    current, recorded with each call."""

    def __init__(self, err=0):
        self.calls, self.err, self.current, self.devices = [], err, None, []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            self.devices.append(self.current)
            return self.err

        return call


def mock_library(monkeypatch, lib):
    """Every kernel's library is ``lib``; the card's context stays real, so
    a device that is not CUDA is refused as it is without the fake."""
    monkeypatch.setattr(cuda_build, "bind", lambda stem, signatures: lib)
    monkeypatch.setattr(cuda_build, "load_library", lambda stem: lib)
    return lib


def mock_card(monkeypatch, lib, stream=7):
    """:func:`mock_library`, and the card's context mocked too: any device is
    taken, made ``lib.current`` inside the context, with ``stream`` its
    stream."""
    @contextlib.contextmanager
    def on_card(device, who):
        lib.current = device
        try:
            yield stream
        finally:
            lib.current = None

    mock_library(monkeypatch, lib)
    monkeypatch.setattr(cuda_build, "on_card", on_card)
    return lib
