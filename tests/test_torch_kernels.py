"""The top-2 CUDA kernel against its plain PyTorch version.

The kernel cuts the train set into slices, one per cluster rank, and merges
the ranks' partial results.  ``merge_partials`` and ``split_reference`` below
state that merge in plain PyTorch.  On the CPU they are held against the plain
version on the full matrix (the merge loses nothing, whatever the number and
order of the slices); on the card the kernel under every cluster size is held
against them.

This file imports no JAX, so that it also runs on the machine with the card,
where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py

Here, without a card, the CUDA test skips and the dispatch and merge tests run.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ergo_uvo_tpu_torch import cuda_build
from ergo_uvo_tpu_torch.features import top2_matcher
from ergo_uvo_tpu_torch.utils.profiling import COUNTERS

# The main path's shape (512 keypoints, 64-d SURF) and those of
# tests/test_features.py: odd Q, T and D, and T < 8.
SHAPES = [(512, 512, 64), (256, 256, 64), (37, 91, 64), (384, 200, 64),
          (8, 3, 128), (256, 512, 48)]


def unit_descs(n, d, seed, device="cpu"):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=-1, keepdims=True)).to(device)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the kernel: same result as the plain
    version and no launch counted."""
    dq, dt = unit_descs(37, 64, 1), unit_descs(91, 64, 2)
    mt = torch.ones(91, dtype=torch.bool)
    mt[::5] = False
    before = COUNTERS["top2_distances.launches"]
    got = top2_matcher.top2_distances(dq, dt, mt)
    ref = top2_matcher.top2_distances_reference(dq, dt, mt)
    assert COUNTERS["top2_distances.launches"] == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """Without nvcc the build raises and says so; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build._nvcc()


def every_fifth_masked(n, device="cpu"):
    mt = torch.ones(n, dtype=torch.bool, device=device)
    mt[::5] = False
    return mt


# idx1 of a partial result that saw no valid column (an empty slice).
NO_INDEX = 0x7FFFFFFF


def merge_partials(min1, idx1, min2):
    """Merge (Q, S) partial results, one column per slice of the train set.

    ``idx1`` holds global train indices, or ``NO_INDEX`` where a slice had no
    valid column (its distances are then +inf).  The winner of a row is the
    lowest (min1, idx1) pair, and min2 is the smaller of the winner's min2 and
    the best min1 among the other slices.
    """
    best = min1.min(dim=1, keepdim=True).values
    tied = torch.where(min1 == best, idx1, NO_INDEX)
    win_idx = tied.min(dim=1, keepdim=True).values
    winner = tied == win_idx  # one slice a row, or all of them when every slice is empty
    inf = float("inf")
    runner_up = torch.where(winner, inf, min1).min(dim=1).values
    own_second = torch.where(winner, min2, inf).min(dim=1).values
    empty = win_idx[:, 0] == NO_INDEX
    out_min1 = torch.where(empty, inf, best[:, 0])
    out_idx1 = torch.where(empty, 0, win_idx[:, 0]).to(torch.int32)
    return out_min1, out_idx1, torch.minimum(own_second, runner_up)


def split_reference(desc_q, desc_t, mask_t, splits):
    """The plain version computed as the kernel computes it: slice s of
    ``splits`` holds the train rows [s * ceil(T / splits), (s + 1) * ceil(T /
    splits)), each slice gives its rows' (min1, idx1, min2), and
    ``merge_partials`` merges them.

    The distances are those of the plain version, computed once and cut into
    the slices' columns (a library product on a narrower slice may sum in
    another order).
    """
    T = desc_t.shape[0]
    d2 = top2_matcher._masked_distances(desc_q, desc_t, mask_t)
    per = -(-T // splits)
    parts = []
    for s in range(splits):
        lo, hi = min(T, s * per), min(T, (s + 1) * per)
        m1, i1, m2 = top2_matcher._row_top2(d2[:, lo:hi])
        i1 = i1 + lo if bool(mask_t[lo:hi].any()) else torch.full_like(i1, NO_INDEX)
        parts.append((m1, i1, m2))
    return merge_partials(*(torch.stack(x, dim=1) for x in zip(*parts)))


def assert_split_equals_full(dq, dt, mt, splits):
    """Exact equality, no tolerance: the split form cuts the plain version's
    own distance matrix into slices, so the partials hold the same fp32
    values, only regrouped, and the merge must lose none of them."""
    ref = top2_matcher.top2_distances_reference(dq, dt, mt)
    got = split_reference(dq, dt, mt, splits)
    for name, a, b in zip(("min1", "idx1", "min2"), got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), (name, splits, tuple(dt.shape))


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("q,tn,d", SHAPES)
def test_split_reference_equals_reference(q, tn, d, splits):
    """The train set cut into S slices and merged gives the full matrix's
    (min1, idx1, min2) bit for bit, every 5th column masked."""
    assert_split_equals_full(unit_descs(q, d, q), unit_descs(tn, d, tn + 1),
                             every_fifth_masked(tn), splits)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ["all_masked", "T=0", "T=1", "T<S", "one_valid_in_last_slice",
                                  "duplicates_across_slices"])
def test_split_reference_edge_cases(case, splits):
    """Empty and fully masked slices give (+inf, NO_INDEX, +inf) partials
    that never win; of two equal train rows in different slices the lower
    index wins and min2 equals min1."""
    dq = unit_descs(9, 16, 1)
    dt = unit_descs(40, 16, 2)
    mt = torch.ones(40, dtype=torch.bool)
    if case == "all_masked":
        mt[:] = False
    elif case == "T=0":
        dt, mt = dt[:0], mt[:0]
    elif case == "T=1":
        dt, mt = dt[:1], mt[:1]
    elif case == "T<S":
        dt, mt = dt[:5], every_fifth_masked(5)
    elif case == "one_valid_in_last_slice":
        mt[:] = False
        mt[39] = True
    else:
        dt[3] = dq[4]
        dt[37] = dq[4]
    assert_split_equals_full(dq, dt, mt, splits)
    if case == "duplicates_across_slices":
        min1, idx1, min2 = split_reference(dq, dt, mt, splits)
        assert int(idx1[4]) == 3 and float(min1[4]) == float(min2[4])
    if case == "one_valid_in_last_slice":
        min1, idx1, min2 = split_reference(dq, dt, mt, splits)
        assert bool((idx1 == 39).all()) and bool(torch.isinf(min2).all())


def test_merge_partials_ignores_rank_order():
    """Reversing the order of the slices' partial results changes nothing:
    the merge takes the lowest (min1, idx1) pair, not the first it meets.
    Two slices hold an equal row, so the tie on min1 is decided by idx1."""
    dq = unit_descs(9, 16, 1)
    dt = unit_descs(40, 16, 2)
    dt[3] = dq[4]
    dt[37] = dq[4]
    d2 = top2_matcher._masked_distances(dq, dt, every_fifth_masked(40))
    parts = []
    for lo in range(0, 40, 8):
        m1, i1, m2 = top2_matcher._row_top2(d2[:, lo:lo + 8])
        parts.append((m1, i1 + lo, m2))
    stacked = [torch.stack(x, dim=1) for x in zip(*parts)]
    forward = merge_partials(*stacked)
    backward = merge_partials(*(x.flip(1) for x in stacked))
    for a, b in zip(forward, backward):
        assert torch.equal(a, b)
    assert int(forward[1][4]) == 3


@settings(max_examples=60, deadline=None)
@given(q=st.integers(1, 9), tn=st.integers(0, 17), d=st.integers(1, 8),
       splits=st.integers(1, 8), seed=st.integers(0, 2**16))
def test_split_reference_property(q, tn, d, splits, seed):
    """Small random shapes with repeated train rows and a random mask: the
    split form equals the plain version exactly (integer-valued descriptors,
    so equal rows give exactly equal distances and the ties are real)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-2, 3, size=(4, d)).astype(np.float32)
    dt = torch.from_numpy(pool[rng.integers(0, 4, size=tn)])
    dq = torch.from_numpy(pool[rng.integers(0, 4, size=q)])
    mt = torch.from_numpy(rng.random(tn) < 0.7)
    assert_split_equals_full(dq, dt, mt, splits)


@pytest.mark.cuda
def test_top2_kernel_matches_reference_on_cuda():
    """On the card, at every contract shape and the two large shapes with
    every 5th train row masked, and on the edge cases (all rows masked,
    T = 0, T = 1, T below the cluster size, a depth that is no multiple of 4,
    a depth too large for a resident query tile, one query row, the only
    valid column in the last rank's slice, equal
    rows in two ranks' slices): idx exact except on rows whose best and
    second-best distances tie within 1e-5 (fp32 sums in another order),
    distances to 1e-3 (squared distances of unit vectors lie in [0, 4]); the
    same bits under every cluster size; one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    dev = torch.device("cuda")
    cases = []
    shapes = SHAPES + [(2048, 2048, 64), (4096, 4096, 128), (33, 130, 50), (5, 7, 64),
                       (1, 512, 64), (40, 70, 576), (9, 20, 515)]
    for q, tn, d in shapes:
        cases.append((unit_descs(q, d, q, dev), unit_descs(tn, d, tn + 1, dev),
                      every_fifth_masked(tn, dev)))
    dq = unit_descs(512, 64, 3, dev)
    dt = unit_descs(512, 64, 4, dev)
    ones = torch.ones(512, dtype=torch.bool, device=dev)
    cases.append((dq, dt, torch.zeros(512, dtype=torch.bool, device=dev)))
    cases.append((dq, dt[:0].contiguous(), ones[:0].contiguous()))
    cases.append((dq, dt[:1].contiguous(), ones[:1].contiguous()))
    cases.append((dq, torch.cat([dq[:256], dq[:256]]), ones))
    last_only = torch.zeros(512, dtype=torch.bool, device=dev)
    last_only[500] = True  # rank 7 of 8 holds columns 448..511
    cases.append((dq, dt, last_only))
    dup = dt.clone()
    dup[70] = dq[5]   # rank 1's slice
    dup[400] = dq[5]  # rank 6's slice
    cases.append((dq, dup, ones))
    for dq, dt, mt in cases:
        before = COUNTERS["top2_distances.launches"]
        k1, ki, k2 = top2_matcher.top2_distances(dq, dt, mt)
        assert COUNTERS["top2_distances.launches"] == before + 1
        r1, ri, r2 = top2_matcher.top2_distances_reference(dq, dt, mt)
        torch.cuda.synchronize()
        shape = tuple(dq.shape) + tuple(dt.shape)
        tie = (r2 - r1).abs() <= 1e-5 * torch.clamp(r1.abs(), min=1.0)
        assert bool(((ki == ri) | tie).all()), shape
        torch.testing.assert_close(k1, r1, atol=1e-3, rtol=0)
        torch.testing.assert_close(k2, r2, atol=1e-3, rtol=0)
        # The merge across ranks: the same bits under every cluster size, and
        # indices equal (off the same ties) to the plain merge of that many slices.
        for splits in (1, 2, 4, 8):
            forced = top2_matcher.launch_forced(dq, dt, mt, splits)
            for a, b in zip(forced, (k1, ki, k2)):
                assert torch.equal(a, b), (shape, splits)
            s1, si, s2 = split_reference(dq, dt, mt, splits)
            assert bool(((forced[1] == si) | tie).all()), (shape, splits)
            torch.testing.assert_close(forced[0], s1, atol=1e-3, rtol=0)
            torch.testing.assert_close(forced[2], s2, atol=1e-3, rtol=0)
    k1, ki, k2 = top2_matcher.top2_distances(*cases[-1])
    assert int(ki[5]) == 70 and float(k1[5]) == float(k2[5])
    k1, ki, k2 = top2_matcher.top2_distances(*cases[-2])
    assert bool((ki == 500).all()) and bool(torch.isinf(k2).all())
