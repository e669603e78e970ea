"""Spans around the calls that the port's runners make into its layers.

Each per-layer metric's file names the module attributes it wraps
(``SPANS``: label -> list of ``"module:attribute"``), and, for a kernel,
a function that records the shapes of a call (``SHAPES``: label -> fn).
The traced run installs one wrapper per attribute.  In the timed part of
the traced window each call is timed by the host clock between two
``torch.cuda.synchronize()``; in the profiled stretch the wrappers only
record shapes, so that the trace's idle gaps stay the program's own.
"""

from __future__ import annotations

import importlib
import time
from collections import defaultdict

import torch

OFF, TIMED, SHAPES = "off", "timed", "shapes"


class Spans:
    def __init__(self, device: torch.device):
        self.device = device
        self.mode = OFF
        self.seconds: dict[str, list[float]] = defaultdict(list)
        self.shapes: dict[str, list] = defaultdict(list)
        self._installed: list[tuple[object, str, object]] = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wrap(self, label, fn, shape_fn):
        def wrapper(*args, **kwargs):
            if self.mode == TIMED:
                self._sync()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self._sync()
                self.seconds[label].append(time.perf_counter() - t0)
                return out
            if self.mode == SHAPES and shape_fn is not None:
                self.shapes[label].append(shape_fn(*args, **kwargs))
            return fn(*args, **kwargs)

        return wrapper

    def install(self, spans: dict, shape_fns: dict) -> None:
        """Wrap every ``"module:attribute"`` of ``spans`` under its label."""
        for label, targets in spans.items():
            for target in targets:
                module_name, attr = target.split(":")
                module = importlib.import_module(module_name)
                fn = getattr(module, attr)
                self._installed.append((module, attr, fn))
                setattr(module, attr, self._wrap(label, fn, shape_fns.get(label)))

    def remove(self) -> None:
        for module, attr, fn in reversed(self._installed):
            setattr(module, attr, fn)
        self._installed.clear()
