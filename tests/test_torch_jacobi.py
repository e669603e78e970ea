"""The batched Jacobi eigensolver: JAX against the port, and the kernel
against its plain version.

On the CPU ``jacobi_eigh`` takes the plain version, held here to the JAX
package's ``jacobi_eigh`` run eagerly (``jax.disable_jit()``) at the three
sizes the paths use: n = 3 (P3P's pencils), 9 (the 8-point solve and the
refits) and 12 (the PnP DLT).  The ``cuda`` test holds the kernel
(``csrc/jacobi_eigh.cu``) to the plain version on the card, bit for bit.

JAX is imported inside the tests that compare with it, so that the file also
runs on the machine with the card, where JAX is not installed (the JAX tests
then skip):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_jacobi.py
"""

import numpy as np
import pytest
import torch

from ergo_uvo_tpu_torch.geometry import linalg
from ergo_uvo_tpu_torch.utils.profiling import COUNTERS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Hundreds of tiny eager ops a solve run faster on one thread than
    spread over a shared host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_spd(rng, batch, n):
    A = rng.normal(size=(*batch, n, n)).astype(np.float32)
    return A @ np.swapaxes(A, -1, -2) + np.eye(n, dtype=np.float32)


def with_spectrum(rng, w):
    """Q diag(w) Q^T for a random orthogonal Q (float64, then float32)."""
    n = len(w)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return ((Q * np.asarray(w, np.float64)) @ Q.T).astype(np.float32)


def pencils(rng, batch):
    """Symmetric indefinite 3x3 matrices, as P3P's D1 + root * D2."""
    M = rng.normal(size=(*batch, 3, 3)).astype(np.float32)
    return (M + np.swapaxes(M, -1, -2)).astype(np.float32)


def case(name):
    """(A, separated): the input and whether every eigenvalue of every matrix
    stands apart from its neighbours, so that each eigenvector and its sign
    are fixed by the input."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "n3":
        return random_spd(rng, (6,), 3), True
    if name == "n9":
        return random_spd(rng, (6,), 9), True
    if name == "n12":
        return random_spd(rng, (4,), 12), True
    if name == "diagonal":
        # Off-diagonal zeros: every rotation takes the |apq| < 1e-30 guard.
        return np.diag(np.float32([3.0, -1.0, 7.0, 0.5, 2.0, -4.0, 1.5, 9.0, 0.25]))[None], True
    if name == "repeated":
        return with_spectrum(rng, [1.0, 1.0, 1.0, 2.0, 3.0, 3.0, 5.0, 8.0, 13.0])[None], False
    if name == "rank_deficient_8pt":
        # The 8-point normal matrix A^T A of 8 constraint rows: rank 8.
        B = rng.normal(size=(3, 8, 9)).astype(np.float32)
        return np.swapaxes(B, -1, -2) @ B, False
    if name == "p3p_4x3x3x3":
        return pencils(rng, (4, 3)), True
    raise KeyError(name)


CASES = ["n3", "n9", "n12", "diagonal", "repeated", "rank_deficient_8pt", "p3p_4x3x3x3"]


def separated_columns(w, rel=1e-3):
    """(..., n) bool: eigenvalue j lies more than rel x max|w| from the others."""
    scale = np.abs(w).max(-1, keepdims=True)
    gaps = np.where(np.eye(w.shape[-1], dtype=bool), np.inf,
                    np.abs(w[..., :, None] - w[..., None, :]))
    return gaps.min(-1) > rel * scale


@pytest.mark.parametrize("name", CASES)
def test_jacobi_eigh_matches_jax(name):
    """The port's plain route against JAX's eager solve: eigenvalues to 1e-5
    of the largest magnitude (float32 over 7 sweeps), eigenvectors to 1e-4
    with the same sign wherever the eigenvalue is separated (the sign feeds
    E and H); every eigenpair satisfies A v = w v to 1e-4 of the scale."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from ergo_uvo_tpu.geometry import linalg as jlinalg

    A, all_separated = case(name)
    with jax.disable_jit():
        jw, jv = jlinalg.jacobi_eigh(jnp.asarray(A))
    tw, tv = linalg.jacobi_eigh(torch.from_numpy(A.copy()))
    jw, jv, tw, tv = np.asarray(jw), np.asarray(jv), tw.numpy(), tv.numpy()
    assert tw.shape == jw.shape == A.shape[:-1] and tv.shape == jv.shape == A.shape
    scale = np.abs(jw).max(-1, keepdims=True)
    np.testing.assert_allclose(tw / scale, jw / scale, atol=1e-5)

    sep = separated_columns(jw)
    assert sep.all() or not all_separated
    cols = np.broadcast_to(sep[..., None, :], tv.shape)
    np.testing.assert_array_equal(np.sign(np.einsum("...ij,...ij->...j", tv, jv))[sep], 1.0)
    np.testing.assert_allclose(tv[cols], jv[cols], atol=1e-4)
    # Degenerate subspaces: any orthonormal basis of them is right.
    resid = np.einsum("...ij,...jk->...ik", A, tv) - tv * tw[..., None, :]
    assert np.abs(resid).max() <= 1e-4 * scale.max()
    eye = np.broadcast_to(np.eye(A.shape[-1]), A.shape)
    np.testing.assert_allclose(np.einsum("...ji,...jk->...ik", tv, tv), eye, atol=1e-5)


@pytest.mark.parametrize("n", [3, 9])
@pytest.mark.parametrize("sweeps", [0, 1])
def test_jacobi_eigh_matches_jax_at_few_sweeps(sweeps, n):
    """Before convergence the outputs depend on every rotation's order,
    which the kernel keeps: the plain version against JAX's eager solve at 0
    and 1 sweeps on a small seeded batch, eigenvalues to 1e-5 of the largest
    magnitude and eigenvectors to 1e-5, column for column."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from ergo_uvo_tpu.geometry import linalg as jlinalg

    A = random_spd(np.random.default_rng(30 + n + sweeps), (3,), n)
    with jax.disable_jit():
        jw, jv = jlinalg.jacobi_eigh(jnp.asarray(A), sweeps)
    tw, tv = linalg.jacobi_eigh_reference(torch.from_numpy(A.copy()), sweeps)
    jw, jv, tw, tv = np.asarray(jw), np.asarray(jv), tw.numpy(), tv.numpy()
    assert tw.shape == jw.shape == A.shape[:-1] and tv.shape == jv.shape == A.shape
    scale = np.abs(jw).max(-1, keepdims=True)
    np.testing.assert_allclose(tw / scale, jw / scale, atol=1e-5)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    if sweeps == 0:  # the diagonal, sorted, and the identity's columns in that order
        np.testing.assert_array_equal(tw, np.sort(np.diagonal(A, axis1=-2, axis2=-1), -1))
        np.testing.assert_array_equal(np.abs(tv).sum(-2), 1.0)


@pytest.mark.parametrize("name", CASES)
def test_cpu_route_is_the_plain_version_bit_for_bit(name):
    """A CPU tensor takes the plain version: the same bits, no launch
    counted, the input left as it was."""
    A, _ = case(name)
    x = torch.from_numpy(A.copy())
    before = COUNTERS["jacobi_eigh.launches"]
    w, v = linalg.jacobi_eigh(x)
    rw, rv = linalg.jacobi_eigh_reference(x)
    assert COUNTERS["jacobi_eigh.launches"] == before
    assert torch.equal(w.view(torch.int32), rw.view(torch.int32))
    assert torch.equal(v.view(torch.int32), rv.view(torch.int32))
    assert torch.equal(x, torch.from_numpy(A))


@pytest.mark.parametrize("shape,dtype,error", [
    ((4, 9, 9), torch.float64, TypeError),
    ((4, 5, 5), torch.float32, ValueError),
    ((4, 9, 8), torch.float32, ValueError),
    ((9,), torch.float32, ValueError),
])
def test_kernel_refuses_what_it_cannot_take(shape, dtype, error):
    """The wrapper's checks come before any build or launch: another dtype,
    another n or a non-square input raises, and nothing falls back."""
    before = COUNTERS["jacobi_eigh.launches"]
    with pytest.raises(error, match="jacobi_eigh"):
        linalg._launch(torch.zeros(shape, dtype=dtype), 7)
    assert COUNTERS["jacobi_eigh.launches"] == before


def test_kernel_batch_of_zero_launches_nothing():
    """An empty batch returns empty outputs of the right shapes without a
    launch (nor a build)."""
    before = COUNTERS["jacobi_eigh.launches"]
    w, v = linalg._launch(torch.zeros(0, 3, 9, 9), 7)
    assert w.shape == (0, 3, 9) and v.shape == (0, 3, 9, 9)
    assert COUNTERS["jacobi_eigh.launches"] == before


def edge_cases_for_the_card():
    """(name, float32 array) cases beyond CASES: non-finite inputs as P3P's
    invalid sets give, zeros of both signs on the diagonal, the zero matrix."""
    rng = np.random.default_rng(9)
    nan9 = random_spd(rng, (4,), 9)
    nan9[1, 2, 5] = nan9[1, 5, 2] = np.nan
    nan9[2, 4, 4] = np.nan
    nan9[3, 0, 0] = np.inf
    p3p = pencils(rng, (6, 3))
    p3p[1, 2] = np.nan  # a root that was NaN: its whole pencil is NaN
    p3p[3, 0, 1, 2] = p3p[3, 0, 2, 1] = np.inf
    p3p[4, 1, 1, 1] = -np.inf
    signed_zeros = np.diag(np.float32([2.0, -0.0, 0.0, -1.0, -0.0, 3.0, 0.0, 1.0, -2.0]))[None]
    return [("nan_inf_9", nan9), ("nan_inf_p3p", p3p), ("signed_zeros", signed_zeros),
            ("zero_3", np.zeros((2, 3, 3), np.float32)),
            ("n12_rank_deficient", (lambda B: np.swapaxes(B, -1, -2) @ B)(
                rng.normal(size=(3, 11, 12)).astype(np.float32)))]


def same_bits(a, b):
    """Equal bit for bit, any NaN equal to any NaN in the same place."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    return torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


def batch_edges_for_the_card():
    """(name, float32 array) batches that cut the kernel's lane groups, warps
    and blocks: 1, 2, 31, 33, 257 and 513 at n = 9, 1537 at n = 3, 511 at
    n = 12."""
    rng = np.random.default_rng(12)
    cases = [(f"batch_{b}x9x9", random_spd(rng, (b,), 9)) for b in (1, 2, 31, 33, 257, 513)]
    cases.append(("batch_1537x3x3", pencils(rng, (1537,))))
    cases.append(("batch_511x12x12", random_spd(rng, (511,), 12)))
    return cases


@pytest.mark.cuda
def test_jacobi_kernel_matches_plain_version_on_cuda():
    """On the card: the kernel gives the plain version's bits at n = 3, 9 and
    12, on the edge cases (the guard, repeated and zero eigenvalues, NaN and
    inf, signed zeros), on batches that cut its lane groups, warps and
    blocks, on the main shapes at 0 and 1 sweeps too (where an order error
    cannot hide in convergence), on a non-contiguous view and a 2-D input,
    with one launch a call and the input left as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    dev = torch.device("cuda")
    cases = [(name, case(name)[0]) for name in CASES] + edge_cases_for_the_card()
    main = [("main_512x9x9", random_spd(np.random.default_rng(5), (512,), 9)),
            ("p3p_512x3x3x3", pencils(np.random.default_rng(6), (512, 3))),
            ("dlt_512x12x12", random_spd(np.random.default_rng(8), (512,), 12))]
    runs = [(name, A, 7) for name, A in cases + main + batch_edges_for_the_card()]
    runs += [(name, A, sweeps) for sweeps in (0, 1) for name, A in main]
    for name, A, sweeps in runs:
        x = torch.from_numpy(A).to(dev)
        keep = x.clone()
        before = COUNTERS["jacobi_eigh.launches"]
        w, v = linalg.jacobi_eigh(x, sweeps)
        assert COUNTERS["jacobi_eigh.launches"] == before + 1, name
        rw, rv = linalg.jacobi_eigh_reference(x, sweeps)
        torch.cuda.synchronize()
        assert same_bits(w, rw) and same_bits(v, rv), (name, sweeps)
        assert same_bits(x, keep), name
    x = torch.from_numpy(random_spd(np.random.default_rng(7), (8,), 9)).to(dev)
    for view in (x.transpose(-1, -2), x[3]):
        w, v = linalg.jacobi_eigh(view)
        rw, rv = linalg.jacobi_eigh_reference(view)
        assert same_bits(w, rw) and same_bits(v, rv)
    before = COUNTERS["jacobi_eigh.launches"]
    w, v = linalg.jacobi_eigh(torch.zeros(0, 9, 9, device=dev))
    assert w.shape == (0, 9) and v.shape == (0, 9, 9)
    assert COUNTERS["jacobi_eigh.launches"] == before
    with pytest.raises(ValueError, match="jacobi_eigh"):
        linalg.jacobi_eigh(torch.zeros(2, 4, 4, device=dev))
    with pytest.raises(TypeError, match="jacobi_eigh"):
        linalg.jacobi_eigh(torch.zeros(2, 9, 9, device=dev, dtype=torch.float64))
