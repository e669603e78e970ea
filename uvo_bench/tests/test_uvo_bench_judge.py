"""The check's sample and its numbers: the sample gives each kind of frame an
equal share, draws whole chunks of a chunked window, and a flag that differs
reads in ``flags_differ`` even where the velocity and the pose agree."""

import numpy as np

from uvo_bench import judge
from uvo_bench.pipelines import common


def _window(n, essential_every):
    return [{"pass": 0, "index": i,
             "out": {"essential": i % essential_every == 0}} for i in range(n)]


def _frames(chunks):
    assert all(len(c) == 1 for c in chunks)
    return [c[0] for c in chunks]


def test_the_sample_gives_each_kind_an_equal_share():
    window = _window(400, 10)  # 40 essential frames, 360 others
    picks = _frames(common.sample(window, 2**31 + 3, 64, lambda r: r["out"]["essential"]))
    assert len(picks) == 64 and len({r["index"] for r in picks}) == 64
    assert sum(r["out"]["essential"] for r in picks) == 32
    assert all(r["index"] >= 2 for r in picks)
    assert picks == _frames(common.sample(window, 2**31 + 3, 64, lambda r: r["out"]["essential"]))


def test_a_kind_that_runs_short_leaves_its_share_to_the_others():
    window = _window(100, 25)  # frames 25, 50, 75 essential (0 is the start)
    picks = _frames(common.sample(window, 5, 40, lambda r: r["out"]["essential"]))
    assert len(picks) == 40 and sum(r["out"]["essential"] for r in picks) == 3


def test_a_chunked_window_is_sampled_in_whole_chunks():
    window = _window(400, 2) + [{"pass": 1, "index": i, "out": {"essential": False}}
                                for i in range(8)]
    window[-1]["out"] = None  # the last chunk unfinished: never drawn
    chunks = common.sample(window, 2**31 + 3, 4, lambda r: r["out"]["essential"], 16)
    assert len(chunks) == 4
    for c in chunks:
        assert [r["index"] for r in c] == list(range(c[0]["index"], c[0]["index"] + 16))
        assert c[0]["index"] % 16 == 0 and c[0]["pass"] == 0
    # Every chunk of the window is drawn in time, the start's too.
    everything = common.sample(window, 7, 1000, None, 16)
    assert len(everything) == 25 and everything[0][0]["index"] == 0


def _out(valid=True, published=True):
    return {"velocity": np.array([0.35, 0.0, 0.0]), "validity": np.bool_(valid),
            "published": np.bool_(published), "R": np.eye(3), "num_inliers": np.int32(40)}


def test_a_flag_that_differs_reads_where_the_gaps_do_not():
    ref = [_out() for _ in range(8)]
    prog = [_out() for _ in range(7)] + [_out(valid=False)]
    numbers = judge.compare(prog, ref, ("num_inliers",), 0.35)
    assert numbers["velocity_gap"] == 0 and numbers["count_gap"] == 0
    assert numbers["flags_differ"] == 1 / 8
    assert judge.compare(ref, ref, ("num_inliers",), 0.35)["flags_differ"] == 0
