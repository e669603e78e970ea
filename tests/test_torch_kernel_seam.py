"""The one seam every hand-written kernel is reached through: ``cuda_build``.

``use_kernel`` chooses the kernel or the plain version by device, ``bind``
loads a library with its entry points' C types, ``on_card`` makes the card
current and hands over its stream, ``launched`` raises on a ``cudaError`` and
counts.  Here, without a card: the dispatch rule, ``bind``'s types, each
module's signatures against the ``extern "C"`` declarations of its source,
and the top-2 and Jacobi launches through the shared fake of
``tests/kernel_fakes.py`` (the SURF and PnP launches have theirs in
``test_torch_surf_kernel.py`` and ``test_torch_pnp_kernel.py``).

This file imports no JAX, so that it also runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernel_seam.py
"""

import re
import types

import pytest
import torch
from kernel_fakes import FakeLibrary, mock_card, mock_library

from ergo_uvo_tpu_torch import cuda_build
from ergo_uvo_tpu_torch.estimation import pnp
from ergo_uvo_tpu_torch.features import surf_hessian, top2_matcher
from ergo_uvo_tpu_torch.geometry import linalg
from ergo_uvo_tpu_torch.utils.profiling import COUNTERS

# Each source under csrc/ and the module that binds it.
BINDINGS = {"top2_distances": top2_matcher, "jacobi_eigh": linalg, "surf_hessian": surf_hessian,
            "pnp_refine": pnp}


@pytest.mark.parametrize("device,expected", [("cuda", True), ("cpu", False), ("meta", ValueError)])
def test_use_kernel_takes_cuda_and_cpu_and_refuses_the_rest(device, expected):
    if expected is ValueError:
        with pytest.raises(ValueError, match=f"who: no implementation for device {device}"):
            cuda_build.use_kernel(torch.device(device), "who")
    else:
        assert cuda_build.use_kernel(torch.device(device), "who") is expected


def test_bind_sets_the_types_once(monkeypatch):
    """Each entry point gets its argument types, and ``int`` (a
    ``cudaError``) for a result unless its signature names another; a second
    ``bind`` of the stem leaves the types as they are."""
    lib = types.SimpleNamespace(launch=types.SimpleNamespace(), plan=types.SimpleNamespace())
    monkeypatch.setattr(cuda_build, "load_library", lambda stem: lib)
    monkeypatch.setattr(cuda_build, "_BOUND", set())
    signatures = {"launch": [cuda_build.PTR, cuda_build.INT], "plan": ([cuda_build.INT], None)}
    assert cuda_build.bind("stem", signatures) is lib
    assert lib.launch.argtypes == [cuda_build.PTR, cuda_build.INT]
    assert lib.launch.restype is cuda_build.INT
    assert lib.plan.argtypes == [cuda_build.INT] and lib.plan.restype is None
    lib.launch.argtypes = "kept"
    cuda_build.bind("stem", signatures)
    assert lib.launch.argtypes == "kept"


def _c_type(decl: str):
    if "*" in decl:
        return cuda_build.PTR
    return {"int": cuda_build.INT, "float": cuda_build.FLOAT, "void": None}[decl.split()[-2]]


def declared_entry_points(stem: str) -> dict:
    """``name -> (argument types, result type)`` of every ``extern "C"``
    function of ``csrc/<stem>.cu``."""
    src = (cuda_build.CSRC / f"{stem}.cu").read_text()
    out = {}
    for result, name, params in re.findall(r'extern "C" (\w+) (\w+)\(([^)]*)\)', src):
        args = [_c_type(p.strip()) for p in params.split(",")]
        out[name] = (args, _c_type(result + " _"))
    return out


def test_every_source_has_its_binding():
    assert sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")) == sorted(BINDINGS)


@pytest.mark.parametrize("stem", sorted(BINDINGS))
def test_signatures_match_the_sources(stem):
    """A module's ``SIGNATURES`` names every entry point of its source, with
    the source's argument and result types."""
    bound = {name: sig if isinstance(sig, tuple) else (sig, cuda_build.INT)
             for name, sig in BINDINGS[stem].SIGNATURES.items()}
    assert bound == declared_entry_points(stem)


def top2_case(forced=False):
    dq, dt = torch.randn(5, 64), torch.randn(7, 64)
    mt = torch.ones(7, dtype=torch.bool)
    if forced:
        return ((dq, dt, mt), lambda: top2_matcher.launch_forced(dq, dt, mt, 4),
                "top2_distances_launch_forced", (5, 7, 64, 4))
    return (dq, dt, mt), lambda: top2_matcher._launch(dq, dt, mt), "top2_distances_launch", (5, 7, 64)


def jacobi_case():
    A = torch.zeros(2, 3, 9, 9)
    return (A,), lambda: linalg._launch(A, 5), "jacobi_eigh_launch", (6, 9, 5)


# name -> (who, counter, a case: (inputs, call, entry point, the sizes it passes))
KERNELS = {
    "top2_distances": ("top2_distances", "top2_distances.launches", top2_case),
    "launch_forced": ("top2_distances", "top2_distances.launches", lambda: top2_case(forced=True)),
    "jacobi_eigh": ("jacobi_eigh", "jacobi_eigh.launches", jacobi_case),
}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_one_launch_a_call_counted(monkeypatch, kernel):
    """With the library and the card faked: one entry point a call, counted
    once, made with the inputs' device current; it gets the inputs' and the
    outputs' buffers, then the sizes, then the current stream."""
    _, counter, case = KERNELS[kernel]
    lib = mock_card(monkeypatch, FakeLibrary())
    inputs, call, entry, sizes = case()
    before = COUNTERS[counter]
    out = call()
    assert COUNTERS[counter] == before + 1
    [(name, args)] = lib.calls
    assert name == entry and lib.devices == [inputs[0].device]
    ptrs = [x.data_ptr() for x in (*inputs, *out)]
    assert list(args) == ptrs + list(sizes) + [7]


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_tensors_off_the_card_are_refused(monkeypatch, kernel):
    """CPU tensors given to the kernel's wrapper raise before anything is
    launched or counted: the kernel would read host pointers."""
    who, counter, case = KERNELS[kernel]
    lib = mock_library(monkeypatch, FakeLibrary())
    _, call, _, _ = case()
    before = COUNTERS[counter]
    with pytest.raises(ValueError, match=f"{who}: the kernel takes tensors on a CUDA device, got cpu"):
        call()
    assert COUNTERS[counter] == before and not lib.calls


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_a_failed_launch_raises_and_is_not_counted(monkeypatch, kernel):
    who, counter, case = KERNELS[kernel]
    mock_card(monkeypatch, FakeLibrary(err=700))
    _, call, _, _ = case()
    before = COUNTERS[counter]
    with pytest.raises(RuntimeError, match=f"{who}: kernel launch failed: cudaError 700"):
        call()
    assert COUNTERS[counter] == before


def test_no_query_row_launches_nothing(monkeypatch):
    """No query row: empty outputs without a launch, before the card is asked
    for (so CPU tensors return too; the Jacobi kernel's batch of zero is
    tests/test_torch_jacobi.py's)."""
    lib = mock_library(monkeypatch, FakeLibrary())
    before = COUNTERS["top2_distances.launches"]
    out = top2_matcher._launch(torch.zeros(0, 64), torch.zeros(7, 64), torch.ones(7, dtype=torch.bool))
    assert [tuple(o.shape) for o in out] == [(0,)] * 3
    assert COUNTERS["top2_distances.launches"] == before and not lib.calls
